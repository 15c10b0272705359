"""The k-means assignment kernel: its CUDA launcher and its plain version.

Port of ``repro/kernels/kmeans.py`` (the Pallas TPU kernel of the digital
clustering core, paper Fig. 13): for samples x (n, d) and centers (k, d),
the index of the nearest center in Manhattan distance, ties to the lowest
index, as (n,) int32.  Both operands are taken as fp32, as the Pallas body
casts them.  k and d are at most 128, the reference's stated tile limit
(the hardware core's is 32).

* ``kmeans_assign_kernel`` launches the hand-written CUDA kernel
  (``csrc/kmeans_assign.cu``, sm_90a) on CUDA tensors and raises on
  anything else;
* ``kmeans_assign_plain`` is the same function in plain PyTorch: the CPU
  path of ``ops.kmeans_assign`` and the version the kernel is held against
  on the card.

The library is built and loaded inside the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

MAX_K = 128   # centers the kernel holds (the reference's tile limit)
MAX_D = 128   # feature width it holds


def check_limits(x: torch.Tensor, centers: torch.Tensor) -> None:
    """Raise unless x is (n, d) and centers (k, d) with 1 <= k, d <= 128."""
    if x.dim() != 2 or centers.dim() != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"x must be (n, d) and centers (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centers.shape)}")
    k, d = centers.shape
    if not (1 <= k <= MAX_K and 1 <= d <= MAX_D):
        raise ValueError(f"k-means assignment holds 1..{MAX_K} centers of "
                         f"1..{MAX_D} features, got k={k}, d={d}")


def kmeans_assign_plain(x: torch.Tensor, centers: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version: x (n, d); centers (k, d) -> (n,) int32."""
    d = torch.sum(torch.abs(x.to(torch.float32)[:, None, :]
                            - centers.to(torch.float32)[None, :, :]), dim=-1)
    return torch.argmin(d, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The ``kmeans_assign_launch`` C entry point, typed."""
    from repro_torch.kernels import _build
    fn = _build.load("kmeans_assign").cdll.kmeans_assign_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def kmeans_assign_kernel(x: torch.Tensor, centers: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the CUDA kernel: x (n, d); centers (k, d) fp32, contiguous, on
    one CUDA device -> (n,) int32 on the current stream; raises if the
    launch reports an error."""
    for name, t in (("x", x), ("centers", centers)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got "
                             f"{t.device} (x on {x.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_limits(x, centers)
    n, d = x.shape
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"n must lie in [1, 2^31), got {n}")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _launch_fn()(x.data_ptr(), centers.data_ptr(), out.data_ptr(),
                          n, d, centers.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign launch failed: cudaError {rc}")
    return out
