"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191].

Backbone only, as the reference's: the vision tower is a stub — a batch's
precomputed patch embeddings at d_model go through the patch merger and
over the first ``vlm_patches`` token positions; M-RoPE sections (t,h,w) =
(16,24,24) over head_dim/2 = 64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    vocab_size=152064,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    vlm_patches=256,          # stub patch count folded into the sequence
    block_pattern=("attn",),
    grad_accum=4,             # the reference's setting, sized for its TPU mesh
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-72b-reduced", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vlm_patches=8,
        mrope_sections=(4, 2, 2), q_chunk=32, kv_chunk=32)
