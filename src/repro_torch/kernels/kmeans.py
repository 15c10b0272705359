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
  on the card (its sums over d may take another order, so an assignment may
  differ at a near-tie);
* ``kmeans_assign_chain`` is the kernel's own chain in plain PyTorch: each
  distance summed over ascending t in fp32, then ``torch.argmin`` (ties to
  the lowest index), which the kernel equals exactly.

The library is built and loaded inside the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.crossbar import launch_on

MAX_K = 128   # centers the kernel holds (the reference's tile limit)
MAX_D = 128   # feature width it holds
CHUNK = 32    # features a shared-memory chunk holds (DC in the source)
# The kernel's tiles, by index: csrc/kmeans_assign.cu's KMEANS_TILES.
# (TS, TJ, NS, NJ): a TS x TJ register tile of chains a thread, NS x NJ
# threads a block, so BS = TS NS samples a block and BK = TJ NJ centers a
# pass over the features.
KMEANS_TILES = ((4, 8, 16, 16),   # 64 samples x 128 centers: k > 64
                (4, 8, 32, 4),    # 128 x 32: 16 < k <= 32
                (4, 4, 16, 16),   # 64 x 64: 32 < k <= 64
                (1, 4, 16, 4),    # 16 x 16: small n, k <= 16
                (2, 4, 64, 4))    # 128 x 16: k <= 16


def kmeans_tile_dims(tile: int) -> tuple[int, int, int]:
    """(BS, BK, threads) of one block of ``tile``."""
    ts, tj, ns, nj = KMEANS_TILES[tile]
    return ts * ns, tj * nj, ns * nj


def kmeans_smem(tile: int) -> int:
    """Dynamic shared memory of a block of ``tile``: two buffers of BS
    sample rows and BK center rows, CHUNK + 4 words each."""
    bs, bk, _ = kmeans_tile_dims(tile)
    return 2 * (bs + bk) * (CHUNK + 4) * 4


def kmeans_tile(n: int, d: int, k: int) -> int:
    """The tile the kernel takes for n samples of d features and k centers.

    Every chain is one thread's walk over d; a thread's register tile
    feeds 8 TS TJ adds from TS + TJ vector reads, so large tiles suit large
    n, while small n needs small blocks to reach the SMs, and centers
    beyond k are wasted work.  The thresholds come from chip_smoke.py's
    sweep of every tile on an H100.  Every tile gives the same assignment.
    """
    if n <= 8192:    # the launch dominates: blocks enough for the SMs
        return 3 if k <= 16 else 1
    if k > 64:
        return 0
    if k > 32:
        return 2
    return 1 if k > 16 else 4


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


def kmeans_assign_chain(x: torch.Tensor, centers: torch.Tensor
                        ) -> torch.Tensor:
    """The kernel's chain in plain PyTorch: every distance summed as
    ``acc = acc + |x[:, t] - c[:, t]|`` over t ascending from 0 in fp32
    (one IEEE operation each, on any device), then ``torch.argmin`` (ties
    to the lowest index).  x (n, d); centers (k, d) -> (n,) int32."""
    x, c = x.to(torch.float32), centers.to(torch.float32)
    acc = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.float32,
                      device=x.device)
    for t in range(x.shape[1]):
        acc = acc + torch.abs(x[:, t, None] - c[None, :, t])
    return torch.argmin(acc, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The ``kmeans_assign_launch`` C entry point, typed."""
    from repro_torch.kernels import _build
    fn = _build.load("kmeans_assign").cdll.kmeans_assign_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def kmeans_assign_kernel(x: torch.Tensor, centers: torch.Tensor, *,
                         tile: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (n, d); centers (k, d) fp32, contiguous, on
    one CUDA device -> (n,) int32 on the current stream; raises if the
    launch reports an error.  ``tile`` indexes ``KMEANS_TILES``; by default
    the shape picks it (every tile gives the same assignment).  Types,
    layout, limits and the tile are checked before the device, so a
    refusal shows without a card."""
    for name, t in (("x", x), ("centers", centers)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_limits(x, centers)
    if tile is not None and not 0 <= tile < len(KMEANS_TILES):
        raise ValueError(f"tile must index KMEANS_TILES "
                         f"(0..{len(KMEANS_TILES) - 1}), got {tile}")
    return launch(x, centers, tile)


def launch(x: torch.Tensor, centers: torch.Tensor,
           tile: int | None = None) -> torch.Tensor:
    """The launch behind :func:`kmeans_assign_kernel`, for a caller that
    has checked types, layout and limits (``ops.kmeans_assign``): checks n
    and the device, picks the tile where none is given, launches."""
    n, d = x.shape
    k = centers.shape[0]
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"n must lie in [1, 2^31), got {n}")
    if not (x.is_cuda and centers.is_cuda) or \
            x.get_device() != centers.get_device():
        raise ValueError(f"x and centers must lie on one CUDA device, got "
                         f"{x.device} and {centers.device}")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    rc = launch_on(_launch_fn(), x.get_device(), x.data_ptr(),
                   centers.data_ptr(), out.data_ptr(), n, d, k,
                   kmeans_tile(n, d, k) if tile is None else tile)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign launch failed: cudaError {rc}")
    return out
