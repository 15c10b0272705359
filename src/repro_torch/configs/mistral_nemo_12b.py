"""mistral-nemo-12b — dense GQA kv=8, 128k ctx
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    vocab_size=131072,
    d_model=5120,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    rope_theta=1e6,
    block_pattern=("attn",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mistral-nemo-12b-reduced", vocab_size=512, d_model=64,
        n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        q_chunk=32, kv_chunk=32)
