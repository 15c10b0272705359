"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    vocab_size=50280,
    d_model=768,
    n_layers=24,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    block_pattern=("ssd",),
    tie_embeddings=True,
    sub_quadratic=True,
    # SSD heads (24) don't divide a 16-way model axis: layer splitting is
    # inapplicable, so the "model" axis serves as extra data parallelism
    # for this arch (the reference's mesh rules; one card ignores them)
    sharding_overrides=(("batch", ("pod", "data", "model")),
                        ("act_embed", None)),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-130m-reduced", vocab_size=512, d_model=64, n_layers=2,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
