"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596].  The speech frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings at d_model (per the assignment
sheet)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    vocab_size=256206,
    d_model=1024,
    n_layers=12,              # decoder layers
    encoder_layers=12,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_act="relu",
    gated_mlp=False,
    norm="layernorm",
    block_pattern=("attn",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-m4t-medium-reduced", vocab_size=512, d_model=64,
        n_layers=2, encoder_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, q_chunk=32, kv_chunk=32)
