"""LM layers (port of ``repro.layers``): norms, rope, projections,
embedding and head, MLP, attention (windows included), RG-LRU, MoE
(``moe``: GShard top-k dispatch with capacity drops and the auxiliary
loss) and SSD (``ssd``: the Mamba-2 block, its chunked scan and its
recurrent decode step)."""
from repro_torch.layers import moe, ssd  # noqa: F401
