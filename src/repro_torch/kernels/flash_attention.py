"""The flash-attention kernels: their CUDA launchers and plain versions.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel behind
the reference's ``ops.flash_attention``): causal or full softmax attention
with an online softmax, output in q's dtype.  The layout is the reference
wrapper's public one: q (B, Sq, H, hd), k and v (B, Skv, K, hd) with
H % K == 0; query head h reads kv head h // (H // K) (the order of
``jnp.repeat``).  The causal mask counts query and key positions from 0 on
both sides (right for prefill, where Sq == Skv).  hd is at most 256.
The chunked function also takes a sliding ``window`` (RecurrentGemma's
local layers): key j is visible to query i only where i - window < j, the
reference's ``_block_mask``.  The Pallas function has no window, so
neither has the port's.

The reference has two functions of this shape, and ``semantics`` selects
one (``SEMANTICS``):

* ``"pallas"``, its Pallas kernel's body: q widened to fp32 and scaled
  before the product, s, p and the accumulator all fp32;
* ``"chunked"``, its layer's ``chunked_attention`` (``_online_update``):
  q . k taken from the operand values with fp32 accumulation, ``scale``
  multiplying the product, p rounded to v's dtype before p . v (fp32
  accumulation).  This is the LM prefill's function.  In fp32 the two
  differ only by where the scale's rounding falls.

Two CUDA sources (sm_90a) compute them:

* ``csrc/flash_attention_tc.cu`` for bf16 operands, on the tensor cores
  (``wgmma``), hd in ``TC_HEAD_DIMS``; both functions (a template
  parameter), the chunked one with or without a window;
* ``csrc/flash_attention.cu`` for fp32 operands, on the CUDA cores (TF32
  stays off), any hd up to 256; both functions, the chunked one with or
  without a window.

``flash_attention_kernel`` launches the one that fits the operands' dtype
on CUDA tensors and raises on anything else.  ``flash_attention_plain``
(the Pallas function, a naive softmax over the whole score matrix) and
``chunked_attention_plain`` (the chunked function, walking the reference's
``q_chunk``/``kv_chunk`` grid) are the CPU paths and the versions the
kernels are held against on the card.

The kernels compute the forward only.  ``flash_attention_vjp`` is the
backward of either function in plain PyTorch: it recomputes the plain
function under autograd and takes its vector-Jacobian product, as the
reference's training step rematerializes ``chunked_attention``'s blocks
(``jax.checkpoint``) and differentiates them with XLA's autodiff, outside
any Pallas kernel.  ``kernels.ops.flash_attention`` pairs the kernel's
forward with it in a ``torch.autograd.Function`` on CUDA tensors; a
hand-written backward kernel is later work (ROADMAP Queue 2).

The libraries are built and loaded inside the first launch, never at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

MAX_HD = 256       # head width the kernels' accumulators hold
TC_HEAD_DIMS = (16, 32, 64, 128, 256)   # head widths of the tensor-core kernel
NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
SEMANTICS = ("pallas", "chunked")
ROUTES = ("wgmma", "simt")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (B, Sq, H, hd) and k, v (B, Skv, K, hd) with
    H % K == 0, nonempty, and 1 <= hd <= 256."""
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


def check_semantics(semantics: str) -> None:
    """Raise unless ``semantics`` names one of the reference's functions."""
    if semantics not in SEMANTICS:
        raise ValueError(f"semantics must be one of {SEMANTICS}, got "
                         f"{semantics!r}")


def check_window(window: int | None, semantics: str, Sq: int,
                 Skv: int) -> None:
    """Raise unless ``window`` is None or a positive int given with the
    chunked function and Sq <= Skv.  Then every query sees a key (itself
    when causal), so a block wholly outside the band contributes exactly
    0 and the kernels and the plain version may skip it."""
    if window is None:
        return
    if semantics != "chunked":
        raise ValueError(f"a window needs semantics='chunked' (the Pallas "
                         f"function has none), got {semantics!r}")
    if isinstance(window, bool) or not isinstance(window, int) \
            or window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")
    if Sq > Skv:
        raise ValueError(f"a window needs Sq <= Skv, got Sq={Sq}, "
                         f"Skv={Skv}")


def route(dtype: torch.dtype) -> str:
    """The kernel that takes operands of ``dtype``: ``"wgmma"`` (bf16, the
    tensor-core source) or ``"simt"`` (fp32, the CUDA-core source)."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the Pallas function: softmax(scale q . k,
    masked) . v in fp32, q scaled before the product; (B, Sq, H, hd) in
    q's dtype."""
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


def chunked_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            causal: bool = True, q_chunk: int = 512,
                            kv_chunk: int = 512,
                            window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the reference's ``chunked_attention``
    (``_online_update`` step for step): per (q chunk, kv chunk) in
    ascending order, s = (q . k in fp32 from the operand values) * scale,
    -1e30 where masked, running max m and sum l in fp32, p = exp(s - m)
    rounded to v's dtype before p . v (fp32 accumulation), and o / max(l,
    1e-30) cast to q's dtype; (B, Sq, H, hd).

    bf16 operands are multiplied as fp32 copies, which is exact (CPU
    ``einsum`` on bf16 would round its result to bf16).  Each block casts
    its own chunks, so under autograd each block's gradient of q, k and v
    is rounded to their dtype and summed in it, as the reference's
    transposed products and scans do.  A ragged last chunk is shorter
    (the reference asserts that the chunks divide S).  kv chunks past the
    diagonal are skipped when causal: there p = 0 and corr = 1 exactly,
    so skipping leaves the result bit for bit as is.  With a ``window``
    (``check_window``), key j is masked for query i unless i - window <
    j, and kv chunks wholly before a q chunk's band are skipped too: a
    chunk that only precedes the first visible key leaves l and o
    multiplied by corr = exp(-1e30 - m) = 0 when that key arrives, which
    is the reference's banded schedule (``skip_masked_blocks``)."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    f32, dev = torch.float32, q.device
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Skv)
    qg = q.reshape(B, Sq, K, H // K, hd)
    outs = []
    for i0 in range(0, Sq, cq):
        qb = qg[:, i0:i0 + cq]
        n = qb.shape[1]
        m = torch.full((B, K, H // K, n), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((B, K, H // K, n), dtype=f32, device=dev)
        o = torch.zeros((B, K, H // K, n, hd), dtype=f32, device=dev)
        for j0 in range(0, Skv, ck):
            if causal and j0 > i0 + n - 1:
                break
            if window is not None and j0 + ck <= i0 - window + 1:
                continue          # below the band of every query here
            kb, vb = k[:, j0:j0 + ck], v[:, j0:j0 + ck]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb.to(f32),
                             kb.to(f32)) * scale
            if causal or window is not None:
                qi = i0 + torch.arange(n, device=dev)[:, None]
                ki = j0 + torch.arange(kb.shape[1], device=dev)[None, :]
                masked = (ki > qi) & causal
                if window is not None:
                    masked = masked | (ki <= qi - window)
                s = s.masked_fill(masked, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).to(f32), vb.to(f32))
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                        # (B, K, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, scale: float,
                        causal: bool = True, semantics: str = "chunked",
                        q_chunk: int = 512, kv_chunk: int = 512,
                        window: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the operands' dtypes: the vector-Jacobian product
    with ``dout`` of the plain function of ``semantics``
    (``chunked_attention_plain`` over the ``q_chunk`` x ``kv_chunk`` grid,
    or ``flash_attention_plain``), recomputed under autograd on the
    operands' device.  The reference differentiates its
    ``chunked_attention`` the same way (rematerialized blocks, XLA
    autodiff); this is the backward of ``ops.flash_attention``."""
    check_semantics(semantics)
    check_window(window, semantics, q.shape[1], k.shape[1])
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        if semantics == "chunked":
            out = chunked_attention_plain(qg, kg, vg, scale=scale,
                                          causal=causal, q_chunk=q_chunk,
                                          kv_chunk=kv_chunk, window=window)
        else:
            out = flash_attention_plain(qg, kg, vg, scale=scale,
                                        causal=causal)
        return torch.autograd.grad(out, (qg, kg, vg), dout)


@functools.lru_cache(maxsize=None)
def _launch_fn(name: str):
    """The ``<name>_launch`` C entry point of ``csrc/<name>.cu``, typed."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load(name).cdll, f"{name}_launch")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, i32, i32, i32,
                   ctypes.POINTER(ctypes.c_longlong), ptr]
    fn.restype = ctypes.c_int
    return fn


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the tensor-core kernel can copy ``t``'s rows as they lie
    (16-byte ``cp.async`` copies): unit inner stride, 16-byte aligned
    start and row strides."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, scale: float,
                           causal: bool = True,
                           semantics: str = "pallas",
                           window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel of ``semantics``: q (B, Sq, H, hd); k, v (B,
    Skv, K, hd), all fp32 or all bf16, on one CUDA device -> (B, Sq, H,
    hd) contiguous in q's dtype, on the current stream; raises if the
    launch reports an error.

    fp32 operands go to the CUDA-core kernel, read through any strides.
    bf16 operands go to the tensor-core kernel, which takes hd in
    ``TC_HEAD_DIMS`` (raises otherwise) and copies 16-byte rows
    asynchronously: an operand whose inner stride is not 1, or whose start
    or other strides are not 16-byte aligned, is first copied contiguous
    here, and each such copy is counted on
    ``flash_attention_kernel.operand_copies``.  Each launch is counted on
    ``flash_attention_kernel.routes["<route>/<semantics>"]`` (``route``:
    the source it went to).  ``window`` (the chunked function only, Sq <=
    Skv: ``check_window``) bands the keys; a window of Skv or more gives
    the causal kernel's output bit for bit.  A launch with a window also
    counts on ``flash_attention_kernel.windowed``."""
    check_semantics(semantics)
    for t in (q, k, v):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"q, k and v must all be float32 or all "
                            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_shapes(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    check_window(window, semantics, Sq, Skv)
    tc = route(q.dtype) == "wgmma"
    if tc and hd not in TC_HEAD_DIMS:
        raise ValueError(f"the tensor-core flash kernel takes head widths "
                         f"{TC_HEAD_DIMS}, got hd={hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got "
                             f"{t.device} (q on {q.device})")
    if B > 65535 or H > 65535 or max(Sq, Skv) >= 2 ** 31 - 64:
        raise ValueError(f"grid limits: B and H <= 65535, sequences < 2^31, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    if tc:
        ready = []
        for t in (q, k, v):
            if not _rows_aligned(t):
                t = t.clone(memory_format=torch.contiguous_format)
                flash_attention_kernel.operand_copies += 1
            ready.append(t)
        q, k, v = ready
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    fn = _launch_fn("flash_attention_tc" if tc else "flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, K, Sq, Skv, hd, scale, int(causal),
                int(semantics == "chunked"),
                0 if window is None else min(window, Skv), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    flash_attention_kernel.routes[f"{route(q.dtype)}/{semantics}"] += 1
    flash_attention_kernel.windowed += window is not None
    return out


flash_attention_kernel.operand_copies = 0
flash_attention_kernel.windowed = 0
flash_attention_kernel.routes = {f"{r}/{s}": 0 for r in ROUTES
                                 for s in SEMANTICS}
