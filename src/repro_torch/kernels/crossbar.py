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
MAX_N_TRAIN = 128        # fused kernel: columns a dx block holds in B
MAX_N_DX_WALK = 128      # bwd: above, the kernel rings N (dx_ring_walk)
DX_RUN = 8               # fused kernel: row tiles a dx block walks at most
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
# The tiles of the forward kernel, by index: csrc/row_product.cuh's
# ROW_PRODUCT_TILES.  (TM, TC, NTC, NTM, BR, S): a TM x TC register tile a
# thread, NTC x NTM compute threads a block (whole warps, and a producer
# warp), so BM = TM NTM rows and BC = TC NTC columns a block; BR fan-in
# lines a stage, S stages in the ring.
ROW_PRODUCT_TILES = ((8, 4, 25, 6, 32, 3),    # 48 x 100: many outputs
                     (8, 4, 25, 8, 32, 3),    # 64 x 100: a grid of ~128
                     (4, 4, 8, 16, 32, 4),    # 64 x 32: few outputs
                     (4, 4, 4, 16, 32, 4))    # 64 x 16: N <= 16
# The tiles of the error-backprop kernel, by index: csrc/crossbar_bwd.cu's
# CROSSBAR_BWD_TILES, laid out as ROW_PRODUCT_TILES: BM = TM NTM rows and
# BC = TC NTC columns of dx a block; BR lines a ring stage where N > 128
# (at N <= 128 a stage is a whole row tile), S stages.
CROSSBAR_BWD_TILES = ((4, 4, 8, 16, 32, 2),   # 64 x 32: most launches
                      (4, 4, 8, 16, 32, 3),   # fp32 rings (N > 128)
                      (4, 4, 8, 8, 32, 3))    # 32 x 32: few outputs
BWD_RUN = 8              # bwd: row tiles a block walks at most (N <= 128)
BWD_BLOCKS = 200         # bwd: the fewest blocks a run may leave


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


def row_tile_dims(tile: int) -> tuple[int, int]:
    """(BM, BC): the rows and columns of one block of forward ``tile``."""
    tm, tc, ntc, ntm, _, _ = ROW_PRODUCT_TILES[tile]
    return tm * ntm, tc * ntc


def row_product_tile(T: int, M: int, K: int, N: int) -> int:
    """The tile the forward kernel takes for a (T, M, K, N) stack.

    Every output is one thread's walk over all K fan-in lines.  Tiles of
    25 x 4 columns cover N = 100 (every chip stage) and its multiples
    without padding, with 8 x 4 register tiles; where a stage has few
    outputs (one core: 409,600) their blocks leave SMs idle and 4 x 4
    tiles of 32 columns spread further, of 16 columns below 100,000
    outputs and for N <= 16.  The thresholds come from chip_smoke.py's
    sweep of every tile on an H100 at the main paths' shapes.  The
    summation order does not depend on the tile."""
    outputs = T * M * N
    if N <= 16 or outputs < 100_000:
        return 3
    if outputs >= 1_000_000:
        return 0
    if outputs >= 600_000:
        return 1
    return 2


def bwd_tile_dims(tile: int) -> tuple[int, int]:
    """(BM, BC): the rows and columns of dx one block of bwd ``tile``
    holds."""
    tm, tc, ntc, ntm, _, _ = CROSSBAR_BWD_TILES[tile]
    return tm * ntm, tc * ntc


def _r128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def bwd_smem(tile: int, N: int, d_bytes: int) -> int:
    """Dynamic shared memory of a bwd block, as csrc/row_product.cuh sizes
    it: at N <= 128 (dx_walk) B, N x (BC + 4) words of w^T, and S stages
    of a whole row tile (BM rows at a pitch P >= N, P = 4 mod 8; int8 codes
    also their 16-byte windows) and two mbarriers a stage; above
    (dx_ring_walk) S stages of d (BM x (BR + 4) words), w^T (BR x BC), the
    g+ and g- boxes (BC x (BR + 4) each) and int8 windows, and three
    mbarriers a stage."""
    tm, tc, ntc, ntm, br, stages = CROSSBAR_BWD_TILES[tile]
    bm, bc = tm * ntm, tc * ntc
    if N <= MAX_N_DX_WALK:
        p = -(-N // 4) * 4
        p += 0 if p // 4 % 2 else 4
        stage = _r128(4 * bm * p)
        if d_bytes == 1:
            stage += _r128(bm * ((p + 15) // 16 * 16 + 16))
        return _r128(4 * N * (bc + 4)) + stages * (stage + 16)
    ap = br + 4
    stage = _r128(4 * bm * ap) + _r128(4 * br * bc) + 2 * _r128(4 * bc * ap)
    if d_bytes == 1:
        stage += _r128(bm * ((br + 15) // 16 * 16 + 16))
    return stages * (stage + 24)


def bwd_tile(T: int, M: int, K: int, N: int, d_bytes: int = 4) -> int:
    """The tile the error-backprop kernel takes for a (T, M, K, N) stack.

    Every output is one thread's walk over all N lines.  4 x 4 register
    tiles of 64 rows by 32 columns in two ring stages take every chip
    stage; where N > 128 the ring walk prefers three stages for fp32
    errors (int8 codes keep two: the producer dequantizes them); a small
    output (crossbar_apply's layers at M = 64) takes 32-row blocks that
    reach more SMs.  The choices come from chip_smoke.py's sweep of every
    tile and run on an H100.  The summation order does not depend on the
    tile."""
    if T * M * K < 100_000:
        return 2
    return 1 if N > MAX_N_DX_WALK and d_bytes == 4 else 0


def bwd_run(T: int, M: int, K: int, N: int, tile: int) -> int:
    """Row tiles a block of bwd ``tile`` walks where N <= 128: the longest
    run of 8, 4, 2 or 1 (at most the core's row tiles) that still leaves
    BWD_BLOCKS blocks in the grid, split evenly over the core's row tiles
    (1 above N = 128, where a block holds one row tile).  A run shares the
    block's columns of w; too few blocks leave SMs idle."""
    bm, bc = bwd_tile_dims(tile)
    m_tiles = -(-M // bm)
    if N > MAX_N_DX_WALK:
        return 1
    blocks = T * -(-K // bc)
    run = next((r for r in (BWD_RUN, 4, 2)
                if r <= m_tiles and blocks * -(-m_tiles // r) >= BWD_BLOCKS),
               1)
    return -(-m_tiles // -(-m_tiles // run))


@functools.lru_cache(maxsize=1024)
def _bwd_plan(T: int, M: int, K: int, N: int, d_bytes: int
              ) -> tuple[int, int]:
    """The picked (tile, run) of a shape, computed once (host time)."""
    tile = bwd_tile(T, M, K, N, d_bytes)
    return tile, bwd_run(T, M, K, N, tile)


def train_dx_run(M: int, tile: int) -> int:
    """Row tiles a dx block of the fused kernel walks, for update ``tile``:
    up to DX_RUN, split evenly over the core's row tiles.  A run amortizes
    forming the block's columns of w and fills the ring; a sweep of the
    run on an H100 found 8 best, or level with the best, at the main
    paths' stacks (T = 1, 2, 6 at M = 4096; T = 40 at M = 256)."""
    m_tiles = -(-M // train_dx_dims(tile)[0])
    return -(-m_tiles // -(-m_tiles // DX_RUN))


def train_dx_dims(tile: int) -> tuple[int, int]:
    """(BM, BC) of the fused kernel's dx and y blocks under update
    ``tile``: 4 x 4 register tiles, 8 column groups by as many row groups
    as the update walk's compute warps allow (row_product::TrainTile)."""
    _, _, wk, wn, _, _ = OUTER_PRODUCT_TILES[tile]
    return 4 * (32 * wk * wn // 8), 32


def train_blocks(T: int, M: int, K: int, N: int, tile: int, dx_run: int,
                 compute_y: bool) -> int:
    """The fused kernel's one-dimensional grid: update blocks (the walk's
    BK x BN tiles), dx blocks (runs of ``dx_run`` row tiles of 32 columns)
    and, with ``compute_y``, y blocks, for every core."""
    bk, bn = tile_dims(tile)
    bm, bc = train_dx_dims(tile)
    m_tiles = -(-M // bm)
    per_core = (-(-K // bk) * -(-N // bn)
                + -(-K // bc) * -(-m_tiles // dx_run))
    if compute_y:
        per_core += -(-N // bc) * m_tiles
    return T * per_core


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def crossbar_fwd_plain(xs: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, *, activation: bool = True,
                       adc_bits: int | None = None,
                       adc_range: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: xs (T, M, K); g± (T, K, N) -> (T, M, N),
    on the operands' fp32 values (bf16 is upcast before the
    subtraction)."""
    f32 = torch.float32
    o = torch.matmul(xs.to(f32), g_plus.to(f32) - g_minus.to(f32))
    if activation:
        o = torch.clamp(o * 0.25, -0.5, 0.5)
    if adc_bits is not None:
        scale_t = _f32(_adc_scale(adc_bits, adc_range), o)
        o = torch.clamp(o, -adc_range, adc_range)
        o = torch.round((o + adc_range) / scale_t) * scale_t - adc_range
    return o


def _dequant(dys: torch.Tensor, dy_scale: torch.Tensor | None
             ) -> torch.Tensor:
    """Error codes -> values (``codes * scale``); values pass as fp32."""
    if dy_scale is None:
        return dys.to(torch.float32)
    return dys.to(torch.float32) * dy_scale


def crossbar_bwd_plain(dys: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, *,
                       dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: dys (T, M, N); g± (T, K, N) -> (T, M, K),
    on the operands' fp32 values."""
    f32 = torch.float32
    return torch.matmul(_dequant(dys, dy_scale),
                        (g_plus.to(f32) - g_minus.to(f32)).transpose(-1, -2))


def crossbar_dw_plain(xs: torch.Tensor, dys: torch.Tensor, *,
                      dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: xs (T, M, K); dys (T, M, N) -> (T, K, N),
    on the operands' fp32 values."""
    return torch.matmul(xs.to(torch.float32).transpose(-1, -2),
                        _dequant(dys, dy_scale))


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
        "crossbar_fwd": [ptr] * 4 + [i32] * 6 + [f32] * 2 + [i32, ptr],
        "crossbar_bwd": [ptr, i32] + [ptr] * 4 + [i32] * 6 + [ptr],
        "crossbar_dw": [ptr, ptr, i32, ptr, ptr] + [i32] * 5 + [ptr],
        "pulse_update": [ptr] * 6 + [i32] * 4 + [f32] * 4 + [i32, ptr],
        "crossbar_train": ([ptr] * 4 + [i32] + [ptr] * 6 + [i32] * 7
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
    if not t.is_cuda or t.get_device() != like.get_device():
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
    """The dy_kind of the sources; checks that codes come with a scale
    (before the device, so it shows without a card)."""
    kind = _DY_KINDS.get(dys.dtype)
    if kind is not None and (dy_scale is not None) != (kind != 0):
        raise ValueError("dy_scale goes with integer error codes, and only "
                         f"with them (dys is {dys.dtype})")
    _check_operand("dys", dys, dys, tuple(_DY_KINDS))
    if dy_scale is not None and (
            dy_scale.get_device() != dys.get_device()
            or dy_scale.numel() != 1
            or dy_scale.dtype != torch.float32):
        raise ValueError("dy_scale must be one fp32 value on dys's device")
    return kind


# The raw handle of a device's current stream: what
# ``torch.cuda.current_stream(i).cuda_stream`` returns, without building a
# Stream object (some 5 us of host time a launch on an H100 host); PyTorch's
# own generated kernels launch on it.  The public call where it is absent.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch_on(fn, index: int, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and the raw handle of the
    current stream of CUDA device ``index``; returns its code.  A kernel
    launches into the current device's context, so device ``index`` is
    made current first where it is not (only then: entering
    ``torch.cuda.device`` costs more host time than the launch)."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, _raw_stream(index))
    return fn(*args, _raw_stream(index))


def _run(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream; raise on an error."""
    rc = launch_on(_launch_fn(name), device.index, *args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _pick_row_tile(tile: int | None, T: int, M: int, K: int,
                   N: int) -> int:
    """``tile``, or the one :func:`row_product_tile` picks for the shape;
    checks the index and the grid it gives."""
    if tile is None:
        tile = row_product_tile(T, M, K, N)
    if not 0 <= tile < len(ROW_PRODUCT_TILES):
        raise ValueError(f"tile must index ROW_PRODUCT_TILES "
                         f"(0..{len(ROW_PRODUCT_TILES) - 1}), got {tile}")
    bm, bc = row_tile_dims(tile)
    _check_grid(T, -(-M // bm), M=M, K=K, N=N)
    if -(-N // bc) > MAX_GRID_X:
        raise ValueError(f"grid too large: N={N}")
    return tile


def crossbar_fwd_kernel(xs: torch.Tensor, g_plus: torch.Tensor,
                        g_minus: torch.Tensor, *, activation: bool = True,
                        adc_bits: int | None = None, adc_range: float = 0.5,
                        tile: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: xs (T, M, K); g± (T, K, N) -> (T, M, N) fp32.

    Checks device, dtype, shape and contiguity, allocates the output with
    ``torch.empty`` and launches on the current stream; raises if the launch
    reports an error.  ``adc_bits`` fuses the output ADC into the epilogue.
    ``tile`` indexes ``ROW_PRODUCT_TILES``; by default the shape picks it
    (every tile gives the same bits).
    """
    for name, t in (("xs", xs), ("g_plus", g_plus), ("g_minus", g_minus)):
        _check_operand(name, t, xs)
    T, M, K = xs.shape
    N = g_plus.shape[2]
    _check_shapes({"g_plus": (T, K, N), "g_minus": (T, K, N)},
                  {"xs": xs, "g_plus": g_plus, "g_minus": g_minus})
    tile = _pick_row_tile(tile, T, M, K, N)
    scale = _adc_scale(adc_bits, adc_range) if adc_bits is not None else 1.0
    y = torch.empty((T, M, N), dtype=torch.float32, device=xs.device)
    _run("crossbar_fwd", xs.device, xs.data_ptr(), g_plus.data_ptr(),
         g_minus.data_ptr(), y.data_ptr(), T, M, K, N, int(activation),
         int(adc_bits is not None), adc_range, scale, tile)
    return y


def _pick_bwd(tile: int | None, run: int | None, T: int, M: int, K: int,
              N: int, d_bytes: int) -> tuple[int, int]:
    """``tile`` and ``run``, or those :func:`bwd_tile` and :func:`bwd_run`
    pick for the shape; checks the index, the run and the grid they
    give."""
    _check_grid(T, 1, M=M, K=K, N=N)
    if tile is None and run is None:
        tile, run = _bwd_plan(T, M, K, N, d_bytes)
    if tile is None:
        tile = bwd_tile(T, M, K, N, d_bytes)
    if not 0 <= tile < len(CROSSBAR_BWD_TILES):
        raise ValueError(f"tile must index CROSSBAR_BWD_TILES "
                         f"(0..{len(CROSSBAR_BWD_TILES) - 1}), got {tile}")
    if run is None:
        run = bwd_run(T, M, K, N, tile)
    if run < 1:
        raise ValueError(f"run must be at least 1, got {run}")
    bm, bc = bwd_tile_dims(tile)
    m_tiles = -(-M // bm)
    _check_grid(T, m_tiles if N > MAX_N_DX_WALK else -(-m_tiles // run),
                M=M, K=K, N=N)
    if -(-K // bc) > MAX_GRID_X:
        raise ValueError(f"grid too large: K={K}")
    return tile, run


def crossbar_bwd_kernel(dys: torch.Tensor, g_plus: torch.Tensor,
                        g_minus: torch.Tensor, *,
                        dy_scale: torch.Tensor | None = None,
                        tile: int | None = None,
                        run: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: dys (T, M, N); g± (T, K, N) -> dx (T, M, K).

    ``dys`` is fp32, or int8/int32 error codes with a one-element fp32
    ``dy_scale`` on the same device (read by the kernel, no host sync).
    ``tile`` indexes ``CROSSBAR_BWD_TILES`` and ``run`` is the row tiles a
    block walks (N <= 128); by default the shape picks both (every tile
    and run gives the same bits)."""
    kind = _dy_kind(dys, dy_scale)
    for name, t in (("g_plus", g_plus), ("g_minus", g_minus)):
        _check_operand(name, t, dys)
    T, M, N = dys.shape
    K = g_plus.shape[1]
    if g_plus.shape != (T, K, N) or g_minus.shape != (T, K, N):
        _check_shapes({"g_plus": (T, K, N), "g_minus": (T, K, N)},
                      {"dys": dys, "g_plus": g_plus, "g_minus": g_minus})
    tile, run = _pick_bwd(tile, run, T, M, K, N, dys.element_size())
    dx = torch.empty((T, M, K), dtype=torch.float32, device=dys.device)
    _run("crossbar_bwd", dys.device, dys.data_ptr(), kind,
         None if dy_scale is None else dy_scale.data_ptr(),
         g_plus.data_ptr(), g_minus.data_ptr(), dx.data_ptr(), T, M, K, N,
         tile, run)
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
                          w_max: float = 1.0, compute_y: bool = False,
                          tile: int | None = None
                          ) -> tuple[torch.Tensor, ...]:
    """Launch the fused CUDA kernel: g± (T, K, N); xs (T, M, K); ds
    (T, M, N) -> (ys, dxs, g+', g-') as :func:`crossbar_train_plain`, the
    new conductances in fresh tensors (the kernel's dx blocks read g±
    while its update blocks write).

    ``ds`` is fp32, or int8/int32 error codes with a one-element fp32
    ``dy_scale``; ``lr`` is a one-element fp32 tensor on the same device
    (read by the kernel, so a CUDA graph replays with a new value) or a
    Python float (rounded once to a cached fp32 constant).  ``max_dw /
    levels`` is formed in double and rounded once to fp32.  ``tile``
    indexes ``OUTER_PRODUCT_TILES`` (the update walk's, which sets the dx
    blocks' size); by default the shape picks it (every tile gives the
    same bits)."""
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
    if tile is None:
        tile = outer_product_tile(T, M, K, N, ds.element_size())
    if not 0 <= tile < len(OUTER_PRODUCT_TILES):
        raise ValueError(f"tile must index OUTER_PRODUCT_TILES "
                         f"(0..{len(OUTER_PRODUCT_TILES) - 1}), got {tile}")
    dx_run = train_dx_run(M, tile)
    if train_blocks(T, M, K, N, tile, dx_run, compute_y) > MAX_GRID_X:
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
         gp.data_ptr(), gm.data_ptr(), T, M, K, N, int(compute_y), tile,
         dx_run, max_dw / levels, float(levels), w_max)
    return ys, dxs, gp, gm
