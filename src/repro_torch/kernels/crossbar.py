"""The crossbar kernels: their CUDA launchers and their plain versions.

Port of ``repro/kernels/crossbar.py`` (Pallas TPU kernels).  Every function
here takes core stacks with a leading core axis ``T`` and computes, for
every core ``t``:

* forward (``crossbar_fwd_kernel``):
  ``y[t] = ADC(h(xs[t] @ (g_plus[t] - g_minus[t])))``, with ``h`` the
  hard-sigmoid (when ``activation``) and the optional fixed-range
  ``adc_bits`` output ADC, rounding halves to even;
* error backprop (``crossbar_bwd_kernel``):
  ``dx[t] = d[t] @ (g_plus[t] - g_minus[t])^T`` (paper Eq. 7);
* weight gradient (``crossbar_dw_kernel``): ``dw[t] = xs[t]^T @ d[t]``
  (Eq. 6, batch-summed);
* pulse update (``pulse_update_kernel``, III.F step 3):
  ``dw = clip(rint(2 lr (xs[t]^T @ ds[t]) / u), +-levels) * u`` with
  ``u = max_dw / levels``, and ``g± <- clip(g± ± dw/2, 0, w_max)``;
* fused training step (``crossbar_train_kernel``, the compiled step's
  per-stage body): ``y[t]`` (forward without activation, optional), the
  error backprop ``dx[t]`` and the pulse update of ``g±`` in one launch.

In bwd, dw and the fused kernel, ``d`` is either fp32 values or integer
sign-magnitude error codes with a 0-d fp32 ``dy_scale`` (the paper's 8-bit
links), dequantized as ``code * scale`` before the product.

* each ``*_kernel`` launches the hand-written CUDA kernel
  (``csrc/<name>.cu``, fp32, sm_90a) on CUDA tensors and raises on anything
  else;
* each ``*_plain`` is the same function in plain PyTorch: the CPU path of
  the wrappers in ``ops.py``, and the version the kernel is held against on
  the card.

The shared libraries are built and loaded inside the first launch, never at
import, so this module imports without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import device_constant

MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y / gridDim.z
MAX_GRID_X = 2 ** 31 - 1  # ... and on gridDim.x
BLOCK_M = 64             # fwd / bwd: samples per block (BM in the sources)
BLOCK_K_TRAIN = 8        # fused kernel: fan-in lines per update block (UBK)
MAX_N_TRAIN = 128        # fused kernel: columns an update block holds (NMAX)
# dy element types the bwd and dw kernels read (dy_kind in the sources)
_DY_KINDS = {torch.float32: 0, torch.int8: 1, torch.int32: 2}
# The tiles of the dw and pulse kernels, by index: csrc/outer_product.cuh's
# OUTER_PRODUCT_TILES.  (TK, TN, WK, WN, BM, S): a TK x TN register tile a
# thread, WK x WN compute warps of 8 x 4 threads a block (and a producer
# warp), so BK = 8 TK WK fan-in lines and BN = 4 TN WN columns a block; BM
# samples a stage, S stages in the ring.
OUTER_PRODUCT_TILES = ((4, 4, 5, 1, 32, 4),   # many outputs
                       (4, 2, 1, 4, 64, 4),   # many fp32 outputs
                       (4, 2, 3, 1, 64, 4),   # some 50-200 k outputs
                       (2, 2, 3, 1, 64, 4),   # few outputs
                       (4, 2, 1, 4, 32, 4))   # many cores, a short batch


def _adc_scale(adc_bits: int, adc_range: float) -> float:
    """The ADC step 2r/(2^bits - 1), as the reference computes it."""
    return 2.0 * adc_range / float(2 ** adc_bits - 1)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded once to a cached 0-d fp32 constant on ``like``'s
    device: an operation with it is one IEEE fp32 operation on every device
    (a Python-float divisor may become a reciprocal multiply on CUDA)."""
    return device_constant(float(v), torch.float32, like.device)


def tile_dims(tile: int) -> tuple[int, int]:
    """(BK, BN): the fan-in lines and columns of one block of ``tile``."""
    tk, tn, wk, wn, _, _ = OUTER_PRODUCT_TILES[tile]
    return 8 * tk * wk, 4 * tn * wn


def outer_product_tile(T: int, M: int, K: int, N: int,
                       d_bytes: int = 4) -> int:
    """The tile the dw and pulse kernels take for a (T, M, K, N) stack.

    Every output is one thread's walk over all M samples, and a launch is
    bound by how fast shared memory feeds the registers: 4 (TK + TN) bytes
    a sample for TK TN fmaf, so a thread should hold many outputs, while a
    small output needs small tiles to reach every SM.  The thresholds come
    from chip_smoke.py's sweep of every tile on an H100 at the main paths'
    shapes.  The summation order does not depend on the tile."""
    outputs = T * K * N
    if M <= 512 and outputs >= 500_000:
        return 4        # the blocks of many cores share each SM
    if outputs >= 200_000:
        return 1 if d_bytes == 4 else 0   # codes: BN 16 keeps dequant cheap
    if outputs >= 50_000:
        return 2
    return 3


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def crossbar_fwd_plain(xs: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, *, activation: bool = True,
                       adc_bits: int | None = None,
                       adc_range: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: xs (T, M, K); g± (T, K, N) -> (T, M, N)."""
    o = torch.matmul(xs, g_plus - g_minus)
    if activation:
        o = torch.clamp(o * 0.25, -0.5, 0.5)
    if adc_bits is not None:
        scale_t = _f32(_adc_scale(adc_bits, adc_range), o)
        o = torch.clamp(o, -adc_range, adc_range)
        o = torch.round((o + adc_range) / scale_t) * scale_t - adc_range
    return o


def _dequant(dys: torch.Tensor, dy_scale: torch.Tensor | None
             ) -> torch.Tensor:
    """Error codes -> values (``codes * scale``); fp32 values pass."""
    if dy_scale is None:
        return dys
    return dys.to(torch.float32) * dy_scale


def crossbar_bwd_plain(dys: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, *,
                       dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: dys (T, M, N); g± (T, K, N) -> (T, M, K)."""
    return torch.matmul(_dequant(dys, dy_scale),
                        (g_plus - g_minus).transpose(-1, -2))


def crossbar_dw_plain(xs: torch.Tensor, dys: torch.Tensor, *,
                      dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: xs (T, M, K); dys (T, M, N) -> (T, K, N)."""
    return torch.matmul(xs.transpose(-1, -2), _dequant(dys, dy_scale))


def _two_lr(lr: float | torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """fp32(2 lr) as a 0-d tensor: a Python ``lr`` is doubled in double and
    rounded once; a one-element fp32 tensor is doubled in fp32, which is
    exact, so both give the same value for the same double ``lr``."""
    if isinstance(lr, torch.Tensor):
        return 2.0 * lr.reshape(())
    return _f32(2.0 * lr, like)


def pulse_counts_plain(xs: torch.Tensor, ds: torch.Tensor, *,
                       lr: float | torch.Tensor, max_dw: float,
                       levels: int) -> torch.Tensor:
    """The unrounded pulse counts ``2 lr (xs^T @ ds) / u`` (T, K, N), with
    fp32(2 lr) and fp32(u) rounded once, as the kernel forms them."""
    acc = torch.matmul(xs.transpose(-1, -2), ds)
    return _two_lr(lr, acc) * acc / _f32(max_dw / levels, acc)


def pulse_epilogue_plain(g_plus: torch.Tensor, g_minus: torch.Tensor,
                         acc: torch.Tensor, *, lr: float | torch.Tensor,
                         max_dw: float = 0.05, levels: int = 128,
                         w_max: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pulse update from the batch-summed product ``acc`` (T, K, N):
    counts ``clip(round(fp32(2 lr) acc / fp32(u)), +-levels)``, then
    ``g± <- clip(g± ± 0.5 (counts u), 0, w_max)``, one fp32 operation at a
    time in the kernel's order."""
    unit = _f32(max_dw / levels, acc)
    counts = torch.clamp(torch.round(_two_lr(lr, acc) * acc / unit),
                         -levels, levels)
    half = 0.5 * (counts * unit)
    return (torch.clamp(g_plus + half, 0.0, w_max),
            torch.clamp(g_minus - half, 0.0, w_max))


def pulse_update_plain(g_plus: torch.Tensor, g_minus: torch.Tensor,
                       xs: torch.Tensor, ds: torch.Tensor, *,
                       lr: float | torch.Tensor,
                       max_dw: float = 0.05, levels: int = 128,
                       w_max: float = 1.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: g± (T, K, N); xs (T, M, K); ds (T, M, N) ->
    the new (g+, g-): the epilogue on the weight gradient's product."""
    return pulse_epilogue_plain(g_plus, g_minus, crossbar_dw_plain(xs, ds),
                                lr=lr, max_dw=max_dw, levels=levels,
                                w_max=w_max)


def _zero_ys(T: int, M: int, N: int, like: torch.Tensor) -> torch.Tensor:
    """The ``ys`` of a fused step without the forward: zeros, as a
    broadcast view of one cached 0-d constant (nothing is written)."""
    return _f32(0.0, like).expand(T, M, N)


def crossbar_train_plain(g_plus: torch.Tensor, g_minus: torch.Tensor,
                         xs: torch.Tensor, ds: torch.Tensor, *,
                         lr: float | torch.Tensor,
                         dy_scale: torch.Tensor | None = None,
                         max_dw: float = 0.05, levels: int = 128,
                         w_max: float = 1.0, compute_y: bool = False
                         ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version: g± (T, K, N); xs (T, M, K); ds (T, M, N) ->
    (ys (T, M, N), dxs (T, M, K), g+', g-').

    ``ys = xs @ (G+ - G-)`` when ``compute_y``, else zeros; ``dxs`` and the
    pulse update use the dequantized ``ds``.  ``lr`` is a Python float or a
    one-element fp32 tensor."""
    d = _dequant(ds, dy_scale)
    w = g_plus - g_minus
    T, M, N = d.shape
    ys = torch.matmul(xs, w) if compute_y else _zero_ys(T, M, N, d)
    dxs = torch.matmul(d, w.transpose(-1, -2))
    gp, gm = pulse_update_plain(g_plus, g_minus, xs, d, lr=lr,
                                max_dw=max_dw, levels=levels, w_max=w_max)
    return ys, dxs, gp, gm


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _launch_fn(name: str):
    """The ``<name>_launch`` C entry point of ``csrc/<name>.cu``, typed."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load(name).cdll, f"{name}_launch")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        "crossbar_fwd": [ptr] * 4 + [i32] * 6 + [f32] * 2 + [ptr],
        "crossbar_bwd": [ptr, i32] + [ptr] * 4 + [i32] * 4 + [ptr],
        "crossbar_dw": [ptr, ptr, i32, ptr, ptr] + [i32] * 5 + [ptr],
        "pulse_update": [ptr] * 6 + [i32] * 4 + [f32] * 4 + [i32, ptr],
        "crossbar_train": ([ptr] * 4 + [i32] + [ptr] * 6 + [i32] * 5
                           + [f32] * 3 + [ptr]),
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor,
                   dtypes: tuple[torch.dtype, ...] = (torch.float32,)
                   ) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be rank 3, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name} must lie on the first operand's CUDA "
                         f"device, got {t.device} (first on {like.device})")


def _check_shapes(expect: dict[str, tuple[int, ...]],
                  got: dict[str, torch.Tensor]) -> None:
    if any(tuple(got[k].shape) != v for k, v in expect.items()):
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(t.shape)}" for k, t in got.items()))


def _check_grid(T: int, tiles_y: int, **dims: int) -> None:
    if min(T, *dims.values()) < 1:
        raise ValueError(f"empty stack: T={T}, {dims}")
    if T > MAX_GRID_YZ or tiles_y > MAX_GRID_YZ:
        raise ValueError(f"grid too large: T={T}, {dims}")


def _dy_kind(dys: torch.Tensor, dy_scale: torch.Tensor | None) -> int:
    """The dy_kind of the sources; checks that codes come with a scale."""
    _check_operand("dys", dys, dys, tuple(_DY_KINDS))
    kind = _DY_KINDS[dys.dtype]
    if (dy_scale is not None) != (kind != 0):
        raise ValueError("dy_scale goes with integer error codes, and only "
                         f"with them (dys is {dys.dtype})")
    if dy_scale is not None and (
            dy_scale.device != dys.device or dy_scale.numel() != 1
            or dy_scale.dtype != torch.float32):
        raise ValueError("dy_scale must be one fp32 value on dys's device")
    return kind


def _run(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream; raise on an error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _launch_fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def crossbar_fwd_kernel(xs: torch.Tensor, g_plus: torch.Tensor,
                        g_minus: torch.Tensor, *, activation: bool = True,
                        adc_bits: int | None = None,
                        adc_range: float = 0.5) -> torch.Tensor:
    """Launch the CUDA kernel: xs (T, M, K); g± (T, K, N) -> (T, M, N) fp32.

    Checks device, dtype, shape and contiguity, allocates the output with
    ``torch.empty`` and launches on the current stream; raises if the launch
    reports an error.  ``adc_bits`` fuses the output ADC into the epilogue.
    """
    for name, t in (("xs", xs), ("g_plus", g_plus), ("g_minus", g_minus)):
        _check_operand(name, t, xs)
    T, M, K = xs.shape
    N = g_plus.shape[2]
    _check_shapes({"g_plus": (T, K, N), "g_minus": (T, K, N)},
                  {"xs": xs, "g_plus": g_plus, "g_minus": g_minus})
    _check_grid(T, -(-M // BLOCK_M), M=M, N=N)
    scale = _adc_scale(adc_bits, adc_range) if adc_bits is not None else 1.0
    y = torch.empty((T, M, N), dtype=torch.float32, device=xs.device)
    _run("crossbar_fwd", xs.device, xs.data_ptr(), g_plus.data_ptr(),
         g_minus.data_ptr(), y.data_ptr(), T, M, K, N, int(activation),
         int(adc_bits is not None), adc_range, scale)
    return y


def crossbar_bwd_kernel(dys: torch.Tensor, g_plus: torch.Tensor,
                        g_minus: torch.Tensor, *,
                        dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: dys (T, M, N); g± (T, K, N) -> dx (T, M, K).

    ``dys`` is fp32, or int8/int32 error codes with a one-element fp32
    ``dy_scale`` on the same device (read by the kernel, no host sync)."""
    kind = _dy_kind(dys, dy_scale)
    for name, t in (("g_plus", g_plus), ("g_minus", g_minus)):
        _check_operand(name, t, dys)
    T, M, N = dys.shape
    K = g_plus.shape[1]
    _check_shapes({"g_plus": (T, K, N), "g_minus": (T, K, N)},
                  {"dys": dys, "g_plus": g_plus, "g_minus": g_minus})
    _check_grid(T, -(-M // BLOCK_M), M=M, K=K, N=N)
    dx = torch.empty((T, M, K), dtype=torch.float32, device=dys.device)
    _run("crossbar_bwd", dys.device, dys.data_ptr(), kind,
         None if dy_scale is None else dy_scale.data_ptr(),
         g_plus.data_ptr(), g_minus.data_ptr(), dx.data_ptr(), T, M, K, N)
    return dx


def _pick_tile(tile: int | None, T: int, M: int, K: int, N: int,
               d_bytes: int) -> int:
    """``tile``, or the one :func:`outer_product_tile` picks for the shape;
    checks the index and the grid it gives."""
    if tile is None:
        tile = outer_product_tile(T, M, K, N, d_bytes)
    if not 0 <= tile < len(OUTER_PRODUCT_TILES):
        raise ValueError(f"tile must index OUTER_PRODUCT_TILES "
                         f"(0..{len(OUTER_PRODUCT_TILES) - 1}), got {tile}")
    bk, bn = tile_dims(tile)
    _check_grid(T, -(-K // bk), M=M, K=K, N=N)
    if -(-N // bn) > MAX_GRID_X:
        raise ValueError(f"grid too large: N={N}")
    return tile


def crossbar_dw_kernel(xs: torch.Tensor, dys: torch.Tensor, *,
                       dy_scale: torch.Tensor | None = None,
                       tile: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: xs (T, M, K); dys (T, M, N) -> dw (T, K, N).

    ``dys`` as for :func:`crossbar_bwd_kernel`.  ``tile`` indexes
    ``OUTER_PRODUCT_TILES``; by default the shape picks it (every tile
    gives the same bits)."""
    kind = _dy_kind(dys, dy_scale)
    _check_operand("xs", xs, dys)
    T, M, K = xs.shape
    N = dys.shape[2]
    _check_shapes({"dys": (T, M, N)}, {"xs": xs, "dys": dys})
    tile = _pick_tile(tile, T, M, K, N, dys.element_size())
    dw = torch.empty((T, K, N), dtype=torch.float32, device=xs.device)
    _run("crossbar_dw", xs.device, xs.data_ptr(), dys.data_ptr(), kind,
         None if dy_scale is None else dy_scale.data_ptr(), dw.data_ptr(),
         T, M, K, N, tile)
    return dw


def pulse_update_kernel(g_plus: torch.Tensor, g_minus: torch.Tensor,
                        xs: torch.Tensor, ds: torch.Tensor, *, lr: float,
                        max_dw: float = 0.05, levels: int = 128,
                        w_max: float = 1.0, tile: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: g± (T, K, N); xs (T, M, K); ds (T, M, N) ->
    new (g+, g-) in freshly allocated tensors.  ``2 lr`` and
    ``max_dw / levels`` are formed in double and rounded once to fp32.
    ``tile`` as for :func:`crossbar_dw_kernel`."""
    for name, t in (("g_plus", g_plus), ("g_minus", g_minus), ("xs", xs),
                    ("ds", ds)):
        _check_operand(name, t, g_plus)
    T, K, N = g_plus.shape
    M = xs.shape[1]
    _check_shapes({"g_minus": (T, K, N), "xs": (T, M, K), "ds": (T, M, N)},
                  {"g_plus": g_plus, "g_minus": g_minus, "xs": xs, "ds": ds})
    tile = _pick_tile(tile, T, M, K, N, 4)
    gp = torch.empty_like(g_plus)
    gm = torch.empty_like(g_minus)
    _run("pulse_update", g_plus.device, g_plus.data_ptr(),
         g_minus.data_ptr(), xs.data_ptr(), ds.data_ptr(), gp.data_ptr(),
         gm.data_ptr(), T, M, K, N, 2.0 * lr, max_dw / levels,
         float(levels), w_max, tile)
    return gp, gm


def crossbar_train_kernel(g_plus: torch.Tensor, g_minus: torch.Tensor,
                          xs: torch.Tensor, ds: torch.Tensor, *,
                          lr: float | torch.Tensor,
                          dy_scale: torch.Tensor | None = None,
                          max_dw: float = 0.05, levels: int = 128,
                          w_max: float = 1.0, compute_y: bool = False
                          ) -> tuple[torch.Tensor, ...]:
    """Launch the fused CUDA kernel: g± (T, K, N); xs (T, M, K); ds
    (T, M, N) -> (ys, dxs, g+', g-') as :func:`crossbar_train_plain`, the
    new conductances in fresh tensors (the kernel's dx blocks read g±
    while its update blocks write).

    ``ds`` is fp32, or int8/int32 error codes with a one-element fp32
    ``dy_scale``; ``lr`` is a one-element fp32 tensor on the same device
    (read by the kernel, so a CUDA graph replays with a new value) or a
    Python float (rounded once to a cached fp32 constant).  ``max_dw /
    levels`` is formed in double and rounded once to fp32."""
    kind = _dy_kind(ds, dy_scale)
    for name, t in (("g_plus", g_plus), ("g_minus", g_minus), ("xs", xs)):
        _check_operand(name, t, ds)
    T, M, N = ds.shape
    K = g_plus.shape[1]
    _check_shapes({"g_plus": (T, K, N), "g_minus": (T, K, N),
                   "xs": (T, M, K)},
                  {"ds": ds, "g_plus": g_plus, "g_minus": g_minus, "xs": xs})
    _check_grid(T, 1, M=M, K=K, N=N)
    if N > MAX_N_TRAIN:
        raise ValueError(f"the fused kernel holds at most {MAX_N_TRAIN} "
                         f"columns per core, got N={N}")
    per_core = (-(-K // BLOCK_K_TRAIN)
                + -(-K // BLOCK_M) * -(-M // BLOCK_M))   # update + dx
    if compute_y:
        per_core += -(-N // BLOCK_M) * -(-M // BLOCK_M)
    if T * per_core > MAX_GRID_X:   # one-dimensional grid over the stack
        raise ValueError(f"grid too large: M={M}, K={K}, N={N}")
    if not isinstance(lr, torch.Tensor):
        lr = _f32(lr, ds)
    if lr.device != ds.device or lr.numel() != 1 \
            or lr.dtype != torch.float32:
        raise ValueError("lr must be a float or one fp32 value on ds's "
                         "device")
    gp, gm = torch.empty_like(g_plus), torch.empty_like(g_minus)
    dxs = torch.empty((T, M, K), dtype=torch.float32, device=ds.device)
    ys = (torch.empty((T, M, N), dtype=torch.float32, device=ds.device)
          if compute_y else _zero_ys(T, M, N, ds))
    _run("crossbar_train", ds.device, g_plus.data_ptr(), g_minus.data_ptr(),
         xs.data_ptr(), ds.data_ptr(), kind,
         None if dy_scale is None else dy_scale.data_ptr(), lr.data_ptr(),
         ys.data_ptr() if compute_y else None, dxs.data_ptr(),
         gp.data_ptr(), gm.data_ptr(), T, M, K, N, int(compute_y),
         max_dw / levels, float(levels), w_max)
    return ys, dxs, gp, gm
