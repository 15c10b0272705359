"""yi-6b — llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    vocab_size=64000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    rope_theta=5e6,
    block_pattern=("attn",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yi-6b-reduced", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        q_chunk=32, kv_chunk=32)
