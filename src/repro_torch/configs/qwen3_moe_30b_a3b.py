"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, GQA kv=4 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    vocab_size=151936,
    d_model=2048,
    n_layers=48,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                   # all layers MoE
    n_experts=128,
    top_k=8,
    d_expert=768,
    rope_theta=1e6,
    block_pattern=("moe",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-30b-a3b-reduced", vocab_size=512, d_model=64,
        n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=8, top_k=2, d_expert=32, moe_group_size=64,
        q_chunk=32, kv_chunk=32)
