"""moonshot-v1-16b-a3b — Moonlight 64-expert top-6 MoE
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    vocab_size=163840,
    d_model=2048,
    n_layers=48,
    n_heads=16,
    n_kv_heads=16,            # MHA (kv=16)
    head_dim=128,
    d_ff=11264,               # dense first layer FFN
    n_experts=64,
    top_k=6,
    d_expert=1408,
    n_shared_experts=2,
    first_dense_layers=1,
    block_pattern=("moe",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="moonshot-v1-16b-a3b-reduced", vocab_size=512, d_model=64,
        n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        n_experts=8, top_k=2, d_expert=32, n_shared_experts=1,
        moe_group_size=64, q_chunk=32, kv_chunk=32)
