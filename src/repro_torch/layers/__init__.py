"""LM layers (port of ``repro.layers``): norms, rope, projections,
embedding and head, MLP, attention (windows included), RG-LRU, MoE
(``moe``: GShard top-k dispatch with capacity drops and the auxiliary
loss).  SSD waits for its slice (ROADMAP Queue 1 item 10)."""
from repro_torch.layers import moe  # noqa: F401
