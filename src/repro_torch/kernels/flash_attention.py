"""The flash-attention kernel: its CUDA launcher and its plain version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel behind
the reference's ``ops.flash_attention``): causal or full softmax attention
with an online softmax, fp32 inside, output in q's dtype.  The layout is
the reference wrapper's public one: q (B, Sq, H, hd), k and v (B, Skv, K,
hd) with H % K == 0; query head h reads kv head h // (H // K) (the order
of ``jnp.repeat``).  q is widened to fp32 and scaled before the product,
as the Pallas body does.  The causal mask counts query and key positions
from 0 on both sides (the Pallas kernel's mask; right for prefill, where
Sq == Skv).  hd is at most 128.

* ``flash_attention_kernel`` launches the hand-written CUDA kernel
  (``csrc/flash_attention.cu``, sm_90a) on CUDA tensors, read through
  their strides, and raises on anything else;
* ``flash_attention_plain`` is the same function in plain PyTorch (a naive
  softmax over the whole score matrix): the CPU path of
  ``ops.flash_attention`` and the version the kernel is held against on
  the card.

The library is built and loaded inside the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

MAX_HD = 128       # head width the kernel's accumulators hold
NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (B, Sq, H, hd) and k, v (B, Skv, K, hd) with
    H % K == 0, nonempty, and 1 <= hd <= 128."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, Skv, K, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, K, hdk = k.shape
    if Bk != B or hdk != hd or K < 1 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share B and hd, with H a multiple of K")
    if min(B, Sq, Skv) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash attention holds head widths 1..{MAX_HD}, "
                         f"got hd={hd}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: softmax(scale q . k, masked) . v in fp32,
    q scaled before the product; (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    f32 = torch.float32
    qs = (q.to(f32) * scale).reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, k.to(f32))
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The ``flash_attention_launch`` C entry point, typed."""
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").cdll.flash_attention_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, i32, ctypes.POINTER(ctypes.c_longlong),
                   ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, scale: float,
                           causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, Sq, H, hd); k, v (B, Skv, K, hd), all
    fp32 or all bf16, any strides, on one CUDA device -> (B, Sq, H, hd)
    contiguous in q's dtype, on the current stream; raises if the launch
    reports an error."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got "
                             f"{t.device} (q on {q.device})")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"q, k and v must all be float32 or all "
                            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if B > 65535 or H > 65535 or max(Sq, Skv) >= 2 ** 31 - 64:
        raise ValueError(f"grid limits: B and H <= 65535, sequences < 2^31, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), DTYPES[q.dtype], B, H, K, Sq, Skv,
                          hd, scale, int(causal), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    return out
