"""qwen1.5-110b — 80-layer dense GQA kv=8 with QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    vocab_size=152064,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=("attn",),
    # the reference's training setting, kept so the configs compare equal;
    # the port's serving path does not read it
    grad_accum=8,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen1.5-110b-reduced", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        q_chunk=32, kv_chunk=32)
