"""Attention: chunked (flash-style) prefill, cached decode (port of
``repro/layers/attention.py``), with sliding windows (RecurrentGemma's
``local`` layers), bidirectional self-attention and cross-attention (the
seamless encoder and decoder).

Prefill (``cache is None``) is self-attention over the whole sequence,
causal unless the config says otherwise (``AttnConfig.causal``; the
encoder's is False), banded to the last ``window`` keys where the config
has one, through ``chunked_attention``, the reference's own prefill
function: q . k from the operand values with fp32 accumulation, the scale
after the product, p rounded to v's dtype before p . v.  It goes through
``kernels.ops.flash_attention(..., semantics="chunked")``: on CPU tensors
that walks the reference's ``q_chunk``/``kv_chunk`` grid in plain PyTorch
(``kernels/flash_attention.chunked_attention_plain``); on CUDA tensors it
launches the flash kernel (``kernels/csrc/flash_attention_tc.cu`` on the
tensor cores for bf16, ``flash_attention.cu`` for fp32), whose 64-key
tiles round p against another running max than 512-key chunks would.
Decode attends one query over a cache buffer; a windowed layer keeps a
rolling buffer of ``min(max_len, window)`` slots and attends the slots
whose position lies within the window.

bf16 operands enter the products as exact fp32 copies on the CPU, where
the reference asks for fp32 accumulation; only the order of the sums
differs.

Cross-attention (``kv_source``, or a cache with ``"k"`` and no
``"pos"``) projects q only from ``x``; k and v come from the source or
the cross cache, with no RoPE on either side.  One query attends every
source slot through ``decode_attention``; a longer query goes through
``chunked_attention`` non-causal, Sq and Skv apart.

RoPE is M-RoPE (``rope.apply_mrope``) where the config has
``mrope_sections``, its positions then (B, L, 3).

KV caches are updated in place (the port's form of the reference's
donated cache); nothing inside a step is read back to the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.layers.rope import apply_mrope, apply_rope

NEG_INF = -1e30
NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 10)"


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None           # sliding-window size (None = full)
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None
    q_chunk: int = 512
    kv_chunk: int = 512
    skip_masked_blocks: bool = False    # schedule only: same result
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


def attention_spec(cfg: AttnConfig, xbar: XbarMode | None = None) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_spec(d, H * hd, ("fsdp", "heads"), bias=cfg.qkv_bias,
                         xbar=xbar),
        "wk": dense_spec(d, K * hd, ("fsdp", "heads"), bias=cfg.qkv_bias,
                         xbar=xbar),
        "wv": dense_spec(d, K * hd, ("fsdp", "heads"), bias=cfg.qkv_bias,
                         xbar=xbar),
        "wo": dense_spec(H * hd, d, ("heads", "fsdp"), xbar=xbar),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _rope(cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor
          ) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.mrope_sections,
                           theta=cfg.rope_theta)
    return apply_rope(x, positions, theta=cfg.rope_theta)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, causal: bool, window: int | None,
                      q_chunk: int, kv_chunk: int,
                      skip_masked_blocks: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H % K == 0 -> (B, Sq, H,
    hd) in q's dtype.  Query token i is at position i (train/prefill).

    The reference's function: per (q chunk, kv chunk), s = (q . k in fp32)
    * scale, masked to -1e30, online max and sum in fp32, p rounded to v's
    dtype before p . v, through ``ops.flash_attention(...,
    semantics="chunked")``: CPU tensors walk the ``q_chunk`` x
    ``kv_chunk`` grid in plain PyTorch; CUDA tensors launch the flash
    kernel, whose key tile is 64 whatever the chunks.  ``window`` masks
    key j for query i unless i - window < j (the reference's
    ``_block_mask``).  ``skip_masked_blocks`` changes only the reference's
    schedule, causal or banded (a fully masked block contributes exactly 0
    once a valid key has arrived: corr = exp(-1e30 - m) = 0), so it is
    accepted and has no effect.  Sq and Skv may differ (cross-attention
    is non-causal; a causal mask counts both sides from 0)."""
    del skip_masked_blocks
    return kernel_ops.flash_attention(q, k, v, scale=scale, causal=causal,
                                      semantics="chunked", q_chunk=q_chunk,
                                      kv_chunk=kv_chunk, window=window)


# ---------------------------------------------------------------------------
# Decode attention over a cache
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, K, hd); valid: (B, S) bool mask.

    q is rounded to the cache's dtype and p to the value cache's dtype
    before their products, as the reference does; the products themselves
    are fp32."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    G = H // K
    f32 = torch.float32
    qh = q.reshape(B, K, G, hd).to(k_cache.dtype).to(f32)
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.to(f32)) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(f32),
                     v_cache.to(f32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Cache structures
# ---------------------------------------------------------------------------

def init_self_cache(cfg: AttnConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda") -> dict:
    """A layer's cache: ``max_len`` slots for full attention, a rolling
    buffer of ``min(max_len, window)`` slots for a windowed layer
    (``_cache_append`` writes slot length % size), with an
    absolute-position tag per slot and the count of tokens seen.

    ``dtype=torch.int8`` selects the quantized KV cache: sign-magnitude
    int8 codes with one bf16 scale per (batch, slot, kv-head)."""
    size = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                      device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, K, hd) -> int8 codes + per-(B, 1, K) bf16 scale; arithmetic
    in x's dtype, rounding half to even (as ``jnp.round``)."""
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(x / safe[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    return codes.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def _cache_append(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write one token's k/v (B, 1, K, hd) at slot length % size, tag the
    slot with its position and count the token, all in place on the
    device (no host read); returns ``cache``."""
    size = cache["k"].shape[1]
    length = cache["length"]
    slot = torch.remainder(length, size).reshape(1).long()
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"].index_copy_(1, slot, kq)
        cache["v"].index_copy_(1, slot, vq)
        cache["k_scale"].index_copy_(1, slot, ks)
        cache["v_scale"].index_copy_(1, slot, vs)
    else:
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slot, length.reshape(1))
    length.add_(1)
    return cache


# ---------------------------------------------------------------------------
# Full layer (projections + rope + cache management)
# ---------------------------------------------------------------------------

def attention_apply(params: dict, x: torch.Tensor, cfg: AttnConfig, *,
                    positions: torch.Tensor, cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    xbar: XbarMode | None = None,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[torch.Tensor, dict | None]:
    """Self- or cross-attention.

    Self-attention is causal unless ``cfg.causal`` is False, banded to
    ``cfg.window`` keys if it is set.  Prefill: ``cache is None`` and
    ``x`` (B, L, d) is the whole sequence.  Decode: ``x`` is (B, 1, d)
    and ``cache`` holds the k/v buffers, which are updated in place and
    returned.

    Cross-attention: ``kv_source`` (B, S, d), the encoder's output, or a
    cross cache (``"k"`` and ``"v"`` of (B, S, K, hd), no ``"pos"``),
    whose k/v are used as they are.  A cache dict without ``"k"`` is
    filled in place from ``kv_source``."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = x.shape[0]
    cross = kv_source is not None or (cache is not None and "pos" not in cache
                                      and "k" in cache)

    def proj(name, n, src):
        return _split_heads(dense_apply(params[name], src,
                                        compute_dtype=compute_dtype,
                                        xbar=xbar), n, hd)

    q = proj("wq", H, x)

    if cross:
        if cache is None or "k" not in cache:
            k, v = proj("wk", K, kv_source), proj("wv", K, kv_source)
            if cache is not None:
                cache["k"], cache["v"] = k, v
        else:
            k, v = cache["k"], cache["v"]
        if q.shape[1] == 1:
            valid = torch.ones((B, k.shape[1]), dtype=torch.bool,
                               device=q.device)
            y = decode_attention(q, k, v, valid, scale=cfg.scale)
        else:
            y = chunked_attention(q, k, v, scale=cfg.scale, causal=False,
                                  window=None, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk)
    else:
        k, v = proj("wk", K, x), proj("wv", K, x)
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
        if cache is not None:
            # decode: append one token, attend over the valid slots
            cur = cache["length"].clone()      # position of the new token
            _cache_append(cache, k, v)
            kc, vc = cache["k"], cache["v"]
            if "k_scale" in cache:
                kc = _dequantize_kv(kc, cache["k_scale"])
                vc = _dequantize_kv(vc, cache["v_scale"])
            pos = cache["pos"]
            valid = (pos >= 0) & (pos <= cur)
            if cfg.window is not None:
                valid &= pos > cur - cfg.window
            y = decode_attention(q, kc, vc, valid[None, :].expand(B, -1),
                                 scale=cfg.scale)
        else:
            y = chunked_attention(q, k, v, scale=cfg.scale,
                                  causal=cfg.causal, window=cfg.window,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                  skip_masked_blocks=cfg.skip_masked_blocks)

    y = y.reshape(B, y.shape[1], H * hd)
    out = dense_apply(params["wo"], y, compute_dtype=compute_dtype, xbar=xbar)
    return out, cache
