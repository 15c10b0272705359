"""Configurations (mirrors ``repro.configs``): the paper's Table I
applications (``paper_apps``) and the LM architectures the port can build
(``base``: ``ModelConfig``, the registry, ``SHAPES``)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_MODULES,
    SHAPES,
    ModelConfig,
    get_config,
    get_reduced_config,
    list_archs,
    shape_applicable,
)
