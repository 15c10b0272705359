"""recurrentgemma-9b — RG-LRU + local attention, 1 local : 2 recurrent
[arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    vocab_size=256000,
    d_model=4096,
    n_layers=38,
    n_heads=16,
    n_kv_heads=1,             # MQA
    head_dim=256,
    d_ff=12288,
    mlp_act="gelu",
    gated_mlp=True,           # GeGLU
    d_rnn=4096,
    window=2048,
    block_pattern=("rec", "rec", "local"),
    sub_quadratic=True,       # RG-LRU state + O(window) local cache
    grad_accum=2,             # the reference's setting, sized for its TPU mesh
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-9b-reduced", vocab_size=512, d_model=64,
        n_layers=6, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
        d_rnn=64, window=32, q_chunk=32, kv_chunk=32)
