"""The crossbar forward kernel: its CUDA launcher and its plain version.

Port of the forward half of ``repro/kernels/crossbar.py``
(``crossbar_fwd_kernel``, a Pallas TPU kernel).  Both functions here take
core stacks and compute, for every core ``t``,

    y[t] = ADC(h(xs[t] @ (g_plus[t] - g_minus[t])))

with ``h`` the hard-sigmoid (when ``activation``) and the optional
fixed-range ``adc_bits`` output ADC, rounding halves to even.

* :func:`crossbar_fwd_kernel` launches the hand-written CUDA kernel
  (``csrc/crossbar_fwd.cu``, fp32, sm_90a) on CUDA tensors and raises on
  anything else;
* :func:`crossbar_fwd_plain` is the same function in plain PyTorch,
  epilogue included: the CPU path of the wrappers in ``ops.py``, and the
  version the kernel is held against on the card.

The shared library is built and loaded inside the first launch, never at
import, so this module imports without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y / gridDim.z
BLOCK_M = 64             # samples per block (BM in the CUDA source)


def _adc_scale(adc_bits: int, adc_range: float) -> float:
    """The ADC step 2r/(2^bits - 1), as the reference computes it."""
    return 2.0 * adc_range / float(2 ** adc_bits - 1)


def crossbar_fwd_plain(xs: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, *, activation: bool = True,
                       adc_bits: int | None = None,
                       adc_range: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: xs (T, M, K); g± (T, K, N) -> (T, M, N)."""
    o = torch.matmul(xs, g_plus - g_minus)
    if activation:
        o = torch.clamp(o * 0.25, -0.5, 0.5)
    if adc_bits is not None:
        scale = _adc_scale(adc_bits, adc_range)
        # a 0-d tensor divisor keeps the division IEEE on every device
        scale_t = torch.tensor(scale, dtype=o.dtype, device=o.device)
        o = torch.clamp(o, -adc_range, adc_range)
        o = torch.round((o + adc_range) / scale_t) * scale_t - adc_range
    return o


@functools.lru_cache(maxsize=None)
def _launch_fn():
    from repro_torch.kernels import _build
    fn = _build.load("crossbar_fwd").cdll.crossbar_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(xs: torch.Tensor, g_plus: torch.Tensor,
           g_minus: torch.Tensor) -> tuple[int, int, int, int]:
    for name, t in (("xs", xs), ("g_plus", g_plus), ("g_minus", g_minus)):
        if t.device.type != "cuda" or t.device != xs.device:
            raise ValueError(f"{name} must lie on xs's CUDA device, got "
                             f"{t.device} (xs on {xs.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be rank 3, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T, M, K = xs.shape
    N = g_plus.shape[2]
    if g_plus.shape != (T, K, N) or g_minus.shape != (T, K, N):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, g_plus "
                         f"{tuple(g_plus.shape)}, g_minus "
                         f"{tuple(g_minus.shape)}")
    if min(T, M, N) < 1:
        raise ValueError(f"empty stack: T={T}, M={M}, N={N}")
    if T > MAX_GRID_YZ or -(-M // BLOCK_M) > MAX_GRID_YZ:
        raise ValueError(f"grid too large: T={T}, M={M}")
    return T, M, K, N


def crossbar_fwd_kernel(xs: torch.Tensor, g_plus: torch.Tensor,
                        g_minus: torch.Tensor, *, activation: bool = True,
                        adc_bits: int | None = None,
                        adc_range: float = 0.5) -> torch.Tensor:
    """Launch the CUDA kernel: xs (T, M, K); g± (T, K, N) -> (T, M, N) fp32.

    Checks device, dtype, shape and contiguity, allocates the output with
    ``torch.empty`` and launches on the current stream; raises if the launch
    reports an error.  ``adc_bits`` fuses the output ADC into the epilogue.
    """
    T, M, K, N = _check(xs, g_plus, g_minus)
    scale = _adc_scale(adc_bits, adc_range) if adc_bits is not None else 1.0
    y = torch.empty((T, M, N), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = _launch_fn()(xs.data_ptr(), g_plus.data_ptr(),
                          g_minus.data_ptr(), y.data_ptr(), T, M, K, N,
                          int(activation), int(adc_bits is not None),
                          adc_range, scale, stream)
    if rc != 0:
        raise RuntimeError(f"crossbar_fwd launch failed: cudaError {rc}")
    return y
