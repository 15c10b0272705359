"""Data for the paper's applications (port of ``repro.data``).

synthetic  Gaussian-mixture stand-ins for MNIST / ISOLET / KDD / Iris,
           drawn from a ``torch.Generator``
pipeline   ``TokenStream``, the LM training path's deterministic,
           resumable, shardable synthetic token stream
"""
from repro_torch.data.pipeline import TokenStream  # noqa: F401
