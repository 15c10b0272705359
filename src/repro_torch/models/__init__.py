"""LM assembly (port of ``repro.models``): ``lm`` for the decoder-only
dense stack, ``model`` for the ``Model`` facade."""
from repro_torch.models.model import Model, build_model  # noqa: F401
