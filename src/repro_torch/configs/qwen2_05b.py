"""qwen2-0.5b — small dense GQA kv=2 with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    vocab_size=151936,
    d_model=896,
    n_layers=24,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    block_pattern=("attn",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-0.5b-reduced", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        q_chunk=32, kv_chunk=32)
