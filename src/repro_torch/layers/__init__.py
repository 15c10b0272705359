"""LM layers (port of ``repro.layers``): norms, rope, projections,
embedding and head, MLP, attention.  MoE, SSD and RG-LRU wait for their
slice (ROADMAP Queue 1 item 10)."""
