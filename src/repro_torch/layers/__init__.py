"""LM layers (port of ``repro.layers``): norms, rope, projections,
embedding and head, MLP, attention (windows included), RG-LRU.  MoE and
SSD wait for their slices (ROADMAP Queue 1 item 10)."""
