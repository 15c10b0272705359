"""Model configuration and architecture registry (port of
``repro/configs/base.py``).

``ModelConfig`` keeps every field of the reference's, so a config module
copies over unchanged and compares field for field.  The registry lists
only the architectures the port can build: the four dense (``attn``-only)
configs, the hybrid recurrentgemma-9b (``rec`` RG-LRU blocks and
``local`` windowed attention), the MoE family (moonshot-v1-16b-a3b and
qwen3-moe-30b-a3b: ``moe`` blocks after an optional dense prefix) and
the SSM mamba2-130m (``ssd`` blocks, attention-free), the
encoder-decoder seamless-m4t-medium (``models/encdec.py``: bidirectional
encoder, decoder with cross-attention) and the VLM qwen2-vl-72b (M-RoPE,
the patch merger over stub patch embeddings): every architecture of the
reference.  ``reduced()`` of each config module yields the CPU test
variant (same topology, tiny widths).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.layers.attention import AttnConfig
from repro_torch.layers.moe import MoeConfig
from repro_torch.layers.rglru import RGLRUConfig
from repro_torch.layers.ssd import SSDConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    vocab_size: int
    d_model: int
    n_layers: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None        # sliding window for "local" blocks
    mrope_sections: tuple[int, int, int] | None = None

    # --- mlp ---
    d_ff: int = 0
    mlp_act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    first_dense_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024

    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- rglru (griffin) ---
    d_rnn: int = 0

    # --- topology ---
    block_pattern: tuple[str, ...] = ("attn",)   # cycled over n_layers
    encoder_layers: int = 0                      # > 0 => encoder-decoder
    tie_embeddings: bool = False
    vlm_patches: int = 0                         # > 0 => patch-embedding stub

    # --- execution ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    crossbar: bool = False                       # paper technique on/off
    xbar_act_bits: int = 8
    xbar_err_bits: int = 8
    xbar_w_max: float = 4.0
    xbar_paired: bool = True                     # literal (G+,G-) vs (w,c)
    xbar_use_kernel: bool = False                # crossbar kernels' path
    remat: str = "full"                          # none | full | dots
    # chunked_attention's tiling: where its plain version rounds p (the
    # CUDA kernel's key tile is 64 whatever these say)
    q_chunk: int = 512
    kv_chunk: int = 512
    skip_masked_blocks: bool = False
    logits_softcap: float = 0.0
    unroll_layers: bool = False
    grad_accum: int = 1
    # KV-cache storage: "bfloat16" or "int8" (quantized-transport cache,
    # see layers/attention.py).
    kv_cache_dtype: str = "bfloat16"

    # --- capability flags ---
    sub_quadratic: bool = False                  # supports long_500k decode

    sharding_overrides: tuple[tuple[str, Any], ...] | None = None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's layout:
        the pad columns of the head are masked to -1e30)."""
        return -(-self.vocab_size // 256) * 256

    def attn(self, window: int | None = None) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim or self.d_model // max(self.n_heads, 1),
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            window=window, mrope_sections=self.mrope_sections,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
            skip_masked_blocks=self.skip_masked_blocks)

    def moe(self) -> MoeConfig:
        return MoeConfig(
            d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
            d_expert=self.d_expert, n_shared_experts=self.n_shared_experts,
            capacity_factor=self.capacity_factor,
            group_size=self.moe_group_size, act=self.mlp_act)

    def ssd(self) -> SSDConfig:
        return SSDConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, expand=self.ssm_expand,
            n_groups=self.ssm_groups, d_conv=self.ssm_conv,
            chunk=self.ssm_chunk)

    def rglru(self) -> RGLRUConfig:
        return RGLRUConfig(d_model=self.d_model,
                           d_rnn=self.d_rnn or self.d_model)

    def layer_kinds(self) -> list[str]:
        """Per-layer block kinds: optional dense prefix, then the pattern
        cycled."""
        kinds: list[str] = []
        for i in range(self.n_layers):
            if i < self.first_dense_layers:
                kinds.append("attn")
                continue
            kinds.append(self.block_pattern[
                (i - self.first_dense_layers) % len(self.block_pattern)])
        return kinds

    def param_count(self) -> int:
        """Parameters of the port's spec (shapes only, nothing allocated):
        the encoder-decoder's for ``family="encdec"``, else the LM's."""
        from repro_torch.dist.sharding import param_count
        if self.family == "encdec":
            from repro_torch.models.encdec import encdec_spec
            return param_count(encdec_spec(self))
        from repro_torch.models.lm import lm_spec
        return param_count(lm_spec(self))

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        total = self.param_count()
        per_expert = 3 * self.d_model * self.d_expert
        inactive = (self.n_experts - self.top_k) * per_expert * \
            sum(1 for k in self.layer_kinds() if k == "moe")
        return total - inactive


# ---------------------------------------------------------------------------
# Registry: the architectures the port builds
# ---------------------------------------------------------------------------

ARCH_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "qwen1.5-110b": "repro_torch.configs.qwen15_110b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_05b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}


def get_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(ARCH_MODULES[arch])
    cfg: ModelConfig = mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_reduced_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(ARCH_MODULES[arch])
    cfg: ModelConfig = mod.reduced()
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


# ---------------------------------------------------------------------------
# Assigned input shapes (seq_len, global_batch)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped): long_500k needs a sub-quadratic arch."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense-attention decode is "
                       "the quadratic regime long_500k excludes")
    return True, ""
