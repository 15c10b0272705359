"""Public wrappers around the crossbar kernels (port of the crossbar entry
points of ``repro/kernels/ops.py``).

Dispatch: CUDA tensors launch the hand-written kernel
(``crossbar.<name>_kernel``) or raise; CPU tensors take the kernel's plain
version (``crossbar.<name>_plain``), which plays the role the reference's
interpret mode plays on CPU.  There is no fallback from one to the other.
Nothing is padded: the kernels mask ragged edges themselves.

Each wrapper carries a plain integer ``launches`` that it increments where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.

``crossbar_matmul`` is the differentiable product: a
``torch.autograd.Function`` whose forward is the fwd kernel and whose
backward runs the bwd and dw kernels, on 8-bit error codes when
``error_quant``.  ``crossbar_fwd``, ``crossbar_bwd`` and ``crossbar_dw``
take bf16 operands as well as fp32 ones and compute on their
exact fp32 values, as the reference's Pallas kernels cast their operands
inside the kernel: the wrapper upcasts them before the launch (a copy the
kernels' producers could fold in later), and the plain versions upcast
before the subtraction.  Their results are fp32; ``crossbar_matmul``
returns y and dx in x's dtype and dw, -dw in the conductances' dtypes,
as the reference's ``_crossbar_matmul`` casts them.

``crossbar_train_stacked`` is the fused per-stage training step (bwd +
dw + pulse update, optionally the forward) on one launch: the compiled
step's per-stage body (``repro_torch.sim.compiled``).

``kmeans_assign`` is the clustering core's assignment step (the k-means
kernel, ``kernels/kmeans.py``).

``flash_attention`` is fused attention: by default the reference's Pallas
function; with ``semantics="chunked"`` its ``chunked_attention``, the LM
prefill's and the LM training step's (the flash kernels,
``kernels/flash_attention.py``: tensor cores for bf16, CUDA cores for
fp32).  On CUDA tensors it is a ``torch.autograd.Function``: the kernel's
forward, and a backward in plain PyTorch
(``flash_attention.flash_attention_vjp``: the plain function recomputed
under autograd), which is how the reference differentiates its
``chunked_attention`` too (XLA autodiff, outside any Pallas kernel).

Tile autotuner (the reference's block autotuner, ``ops.py:60-246``):
every crossbar wrapper takes ``autotune=`` (default: the
``REPRO_TORCH_XBAR_AUTOTUNE=1`` switch, off) and asks
:func:`block_config` for its launch's tile.  Off, the answer is the
decision lists' pick (``crossbar.row_product_tile``, ``bwd_tile`` and
``bwd_run``, ``outer_product_tile``), cached for dispatch; on, each
candidate tile is timed once per shape on the card by CUDA events after
one warm-up call, the winner is kept and the tuned entries persist to
``.cache/autotune-cuda-sm<major><minor>.json`` (``REPRO_TORCH_AUTOTUNE_TABLE``
names another file; empty: no file).  Nothing is timed on the CPU, where
the plain versions have no tiles, or while a CUDA graph is captured.
Every tile gives the same bits: the summation order does not depend on it.

The reference's conductance pad LRU (``_PAD_CACHE``, ``_cached_pad``) has
no counterpart: the port's kernels mask ragged edges, nothing is padded.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict

import torch

from repro_torch.core import quantization as q
from repro_torch.kernels import crossbar as xbk
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import kmeans as kmk


# ---------------------------------------------------------------------------
# Tile autotuner (memoized per shape, persisted)
# ---------------------------------------------------------------------------
# A bounded LRU: long farm sweeps walk through many (farm size x shape)
# keys.  A value is the port's tile choice: (ROW_PRODUCT_TILES index,) for
# the forward, (CROSSBAR_BWD_TILES index, run) for bwd, and
# (OUTER_PRODUCT_TILES index,) for dw, pulse and the fused kernel.

_BLOCK_CACHE: OrderedDict = OrderedDict()
_BLOCK_CACHE_MAX = 512
_TUNED_KEYS: set = set()      # keys whose entry came from a real timing
                              # pass (only these persist: a cached default
                              # must not suppress later tuning)
_LOADED_TABLES: set = set()   # table paths read into the cache

_AUTOTUNE_ENV = "REPRO_TORCH_XBAR_AUTOTUNE"
_AUTOTUNE_TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"
SMEM_PER_BLOCK = 227 * 1024   # an H100 block's dynamic shared memory


def _autotune_table_path() -> str | None:
    """The persisted tile table: ``REPRO_TORCH_AUTOTUNE_TABLE`` (empty
    string disables persistence), else
    ``.cache/autotune-cuda-sm<major><minor>.json`` anchored at the repo
    root when running from a source checkout (CWD otherwise).  The card's
    architecture is part of the file name, so tiles timed on one GPU never
    pose as another's; it is read only once CUDA is initialized (None
    before), so importing this module touches no device."""
    if _AUTOTUNE_TABLE_ENV in os.environ:
        return os.environ[_AUTOTUNE_TABLE_ENV] or None
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    major, minor = torch.cuda.get_device_capability()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    base = root if os.path.exists(os.path.join(root, "pyproject.toml")) \
        else "."
    return os.path.join(base, ".cache",
                        f"autotune-cuda-sm{major}{minor}.json")


def _block_cache_put(key: tuple, choice: tuple[int, ...],
                     tuned: bool = False) -> None:
    _BLOCK_CACHE[key] = choice
    _BLOCK_CACHE.move_to_end(key)
    if tuned:
        _TUNED_KEYS.add(key)
    while len(_BLOCK_CACHE) > _BLOCK_CACHE_MAX:
        evicted, _ = _BLOCK_CACHE.popitem(last=False)
        _TUNED_KEYS.discard(evicted)


def save_autotune_table(path: str | None = None) -> str | None:
    """Persist the TUNED entries as JSON (one ``op|dims`` key per entry).
    Called after every timing pass.  Untuned defaults cached for dispatch
    are excluded: a persisted default would read as "already tuned" on
    reload and suppress the timing pass forever."""
    path = path or _autotune_table_path()
    if path is None:
        return None
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        table = {"|".join(map(str, k)): list(v)
                 for k, v in _BLOCK_CACHE.items() if k in _TUNED_KEYS}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def load_autotune_table(path: str | None = None) -> int:
    """Load a persisted table into the in-process cache (entries count
    toward the LRU cap and are marked as tuned); returns how many.  Runs
    at import, and again at the first tuned launch if the table's path
    was not known then (the card's name needs CUDA); safe to re-run."""
    path = path or _autotune_table_path()
    if path is None:
        return 0
    _LOADED_TABLES.add(path)
    if not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return 0
    n = 0
    for key, choice in table.items():
        parts = key.split("|")
        try:
            tup = (parts[0],) + tuple(int(p) for p in parts[1:])
            _block_cache_put(tup, tuple(int(c) for c in choice), tuned=True)
            n += 1
        except ValueError:
            continue
    return n


def _autotune_enabled(flag: bool | None) -> bool:
    if flag is not None:
        return flag
    return os.environ.get(_AUTOTUNE_ENV, "0") == "1"


def _kind(op: str) -> str:
    """The kernel an op name launches: fwd, bwd, dw, pulse or train."""
    return op.split("_")[0]


def default_tile(op: str, T: int, M: int, K: int, N: int,
                 d_bytes: int = 4) -> tuple[int, ...]:
    """The decision lists' pick, the tile every launch takes with
    autotuning off."""
    kind = _kind(op)
    if kind == "fwd":
        return (xbk.row_product_tile(T, M, K, N),)
    if kind == "bwd":
        return xbk._bwd_plan(T, M, K, N, d_bytes)
    return (xbk.outer_product_tile(T, M, K, N, d_bytes),)


def _fits(pick, *args) -> bool:
    try:
        pick(*args)
    except ValueError:
        return False
    return True


def tile_candidates(op: str, T: int, M: int, K: int, N: int,
                    d_bytes: int = 4) -> list[tuple[int, ...]]:
    """Every tile choice whose grid and shared memory fit the shape, the
    default first.  The forward's and the batch walk's shared memory does
    not depend on the shape, and every tile's fits a block (the tile
    tests hold it); bwd's grows with N and is checked here, its runs too
    (1 where N > 128, where a block holds one row tile)."""
    kind = _kind(op)
    cands = [default_tile(op, T, M, K, N, d_bytes)]
    if kind == "fwd":
        cands += [(i,) for i in range(len(xbk.ROW_PRODUCT_TILES))
                  if _fits(xbk._pick_row_tile, i, T, M, K, N)]
    elif kind == "bwd":
        for tile in range(len(xbk.CROSSBAR_BWD_TILES)):
            if xbk.bwd_smem(tile, N, d_bytes) > SMEM_PER_BLOCK:
                continue
            m_tiles = -(-M // xbk.bwd_tile_dims(tile)[0])
            runs = [1] if N > xbk.MAX_N_DX_WALK else [
                r for r in (1, 2, 4, xbk.BWD_RUN) if r <= m_tiles]
            cands += [(tile, run) for run in runs
                      if _fits(xbk._pick_bwd, tile, run, T, M, K, N,
                               d_bytes)]
    elif kind == "train":
        cands += [(i,) for i in range(len(xbk.OUTER_PRODUCT_TILES))
                  if N <= xbk.MAX_N_TRAIN and xbk.train_blocks(
                      T, M, K, N, i, xbk.train_dx_run(M, i), True)
                  <= xbk.MAX_GRID_X]
    else:
        cands += [(i,) for i in range(len(xbk.OUTER_PRODUCT_TILES))
                  if _fits(xbk._pick_tile, i, T, M, K, N, d_bytes)]
    return list(dict.fromkeys(cands))


def _elapsed_ms(fn) -> float:
    """One call of ``fn`` timed by CUDA events on the current stream (by
    the host clock where there is no card)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def block_config(op: str, T: int, M: int, K: int, N: int, *,
                 d_bytes: int = 4, fold: int | None = None,
                 autotune: bool | None = None,
                 time_fn=None) -> tuple[int, ...]:
    """The tile choice of an op and (T, M, K, N) stack (``d_bytes``: the
    error operand's element size, int8 codes 1).

    With autotuning off the decision lists' pick (:func:`default_tile`),
    cached for dispatch; a tuned entry does not override it.  On, with a
    ``time_fn(*choice) -> None`` runner, every candidate
    (:func:`tile_candidates`) is timed once by CUDA events after one
    warm-up call and the winner cached, marked as tuned and persisted; a
    tuned entry is reused, an untuned default upgraded in place.  On
    without a runner (a CUDA-graph capture), the tuned entry or else the
    default, which is NOT cached, so a later eager call can still tune.

    ``fold`` is the chip count folded into the core stack and is part of
    the key: a farm of C chips tunes its (C*T, M, K, N) launch once and
    never reuses another farm size's entry."""
    key = ((op, T, M, K, N, d_bytes) if fold is None
           else (op, fold, T, M, K, N, d_bytes))
    tune = _autotune_enabled(autotune)
    if not tune:
        hit = _BLOCK_CACHE.get(key)
        if hit is not None and key not in _TUNED_KEYS:
            _BLOCK_CACHE.move_to_end(key)
            return hit
        choice = default_tile(op, T, M, K, N, d_bytes)
        if hit is None:
            _block_cache_put(key, choice)
        return choice
    if time_fn is not None:
        path = _autotune_table_path()
        if path is not None and path not in _LOADED_TABLES:
            load_autotune_table(path)
    hit = _BLOCK_CACHE.get(key)
    if hit is not None and (key in _TUNED_KEYS or time_fn is None):
        _BLOCK_CACHE.move_to_end(key)
        return hit
    choice = default_tile(op, T, M, K, N, d_bytes)
    if time_fn is None:
        return choice
    best, best_ms = choice, float("inf")
    for cand in tile_candidates(op, T, M, K, N, d_bytes):
        try:
            time_fn(*cand)        # warm-up (and the first call's build)
            ms = _elapsed_ms(lambda: time_fn(*cand))
        except (RuntimeError, ValueError):
            continue
        if ms < best_ms:
            best, best_ms = cand, ms
    _block_cache_put(key, best, tuned=True)
    save_autotune_table()
    return best


load_autotune_table()


# Observers of the plain versions' calls: ``hook(fn, args, kwargs)`` runs
# a kernel's plain version in place of the call (the dry run's cost
# counter registers one to count it as the kernel).  Empty: a direct call.
PLAIN_HOOKS: list = []


def run_plain(fn, *args, **kwargs):
    """Call a kernel's plain version ``fn`` (the CPU path of a wrapper),
    through the innermost of ``PLAIN_HOOKS`` when there is one."""
    if PLAIN_HOOKS:
        return PLAIN_HOOKS[-1](fn, args, kwargs)
    return fn(*args, **kwargs)


def _cuda_operands(tensors, kwargs) -> bool:
    """False when every tensor (``dy_scale`` and a tensor ``lr``
    included) lies on the CPU: the plain version runs."""
    return not (all(t.is_cpu for t in tensors) and all(
        v.is_cpu for v in kwargs.values() if isinstance(v, torch.Tensor)))


def _stack_dims(name: str, tensors) -> tuple[int, int, int, int, int]:
    """(T, M, K, N, d_bytes) of a crossbar kernel's contiguous operands."""
    if name == "crossbar_fwd":
        xs, gp, _ = tensors
        return (*xs.shape, gp.shape[2], 4)
    if name == "crossbar_bwd":
        ds, gp, _ = tensors
        T, M, N = ds.shape
        return T, M, gp.shape[1], N, ds.element_size()
    if name == "crossbar_dw":
        xs, ds = tensors
        return (*xs.shape, ds.shape[2], ds.element_size())
    gp, _, xs, ds = tensors            # pulse_update, crossbar_train
    return (*xs.shape, gp.shape[2], ds.element_size())


def _tile_kwargs(name: str, choice: tuple[int, ...]) -> dict:
    if name == "crossbar_bwd":
        return {"tile": choice[0], "run": choice[1]}
    return {"tile": choice[0]}


def _dispatch(wrapper, name: str, op: str, *tensors, fold: int | None = None,
              autotune: bool | None = None, **kwargs):
    """Run the crossbar kernel ``name``: its plain version when every
    tensor lies on the CPU, else its CUDA kernel on contiguous operands
    with the tile :func:`block_config` gives ``op`` (timing the candidates
    first where autotuning is on and no CUDA graph is being captured),
    counted on ``wrapper.launches``.  Timing launches are not counted."""
    if not _cuda_operands(tensors, kwargs):
        return run_plain(getattr(xbk, f"{name}_plain"), *tensors, **kwargs)
    kernel = getattr(xbk, f"{name}_kernel")
    tensors = [t.contiguous() for t in tensors]
    T, M, K, N, d_bytes = _stack_dims(name, tensors)

    def time_fn(*choice):
        kernel(*tensors, **kwargs, **_tile_kwargs(name, choice))

    choice = block_config(
        op, T, M, K, N, d_bytes=d_bytes, fold=fold, autotune=autotune,
        time_fn=None if tensors[0].is_cuda
        and torch.cuda.is_current_stream_capturing() else time_fn)
    out = kernel(*tensors, **kwargs, **_tile_kwargs(name, choice))
    wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# One crossbar (2-D conductances)
# ---------------------------------------------------------------------------

def _exact_f32(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand as its exact fp32 values (the reference's kernels
    cast inside); fp32 operands and integer codes pass as they are,
    anything else reaches the kernel's own dtype check."""
    return t.to(torch.float32) if t.dtype == torch.bfloat16 else t


def crossbar_fwd(x: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, *, activation: bool = True,
                 adc_bits: int | None = None,
                 adc_range: float = 0.5,
                 autotune: bool | None = None) -> torch.Tensor:
    """y = ADC(h(x @ (G+ - G-))).  x (..., K); g± (K, N) -> (..., N).

    ``adc_bits`` enables the fused output-ADC epilogue (transport
    quantization without a separate op between layers).  ``autotune`` as
    in :func:`block_config`."""
    lead = x.shape[:-1]
    K, N = g_plus.shape
    x, g_plus, g_minus = map(_exact_f32, (x, g_plus, g_minus))
    y = _dispatch(crossbar_fwd, "crossbar_fwd", "fwd", x.reshape(1, -1, K),
                  g_plus[None], g_minus[None], autotune=autotune,
                  activation=activation, adc_bits=adc_bits,
                  adc_range=adc_range)
    return y.reshape(*lead, N)


crossbar_fwd.launches = 0


def crossbar_bwd(dy: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, *,
                 dy_scale: torch.Tensor | None = None,
                 autotune: bool | None = None) -> torch.Tensor:
    """dx = dequant(dy) @ (G+ - G-)^T.  dy (..., N); g± (K, N) -> (..., K).

    With ``dy_scale``, ``dy`` holds integer sign-magnitude error codes,
    dequantized in-kernel as ``codes * scale``."""
    lead = dy.shape[:-1]
    K, N = g_plus.shape
    dy, g_plus, g_minus = map(_exact_f32, (dy, g_plus, g_minus))
    dx = _dispatch(crossbar_bwd, "crossbar_bwd", "bwd", dy.reshape(1, -1, N),
                   g_plus[None], g_minus[None], autotune=autotune,
                   dy_scale=dy_scale)
    return dx.reshape(*lead, K)


crossbar_bwd.launches = 0


def crossbar_dw(x: torch.Tensor, dy: torch.Tensor, *,
                dy_scale: torch.Tensor | None = None,
                autotune: bool | None = None) -> torch.Tensor:
    """dw = x^T @ dequant(dy), summed over every leading axis.
    x (..., K); dy (..., N) -> (K, N)."""
    K, N = x.shape[-1], dy.shape[-1]
    x, dy = _exact_f32(x), _exact_f32(dy)
    return _dispatch(crossbar_dw, "crossbar_dw", "dw", x.reshape(1, -1, K),
                     dy.reshape(1, -1, N), autotune=autotune,
                     dy_scale=dy_scale)[0]


crossbar_dw.launches = 0


def pulse_update(g_plus: torch.Tensor, g_minus: torch.Tensor,
                 x: torch.Tensor, delta: torch.Tensor, *, lr: float,
                 max_dw: float = 0.05, levels: int = 128,
                 w_max: float = 1.0, autotune: bool | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pulse update.  x (..., K); delta (..., N); g± (K, N) -> the
    new (g+, g-)."""
    K, N = g_plus.shape
    gp, gm = _dispatch(pulse_update, "pulse_update", "pulse", g_plus[None],
                       g_minus[None], x.reshape(1, -1, K),
                       delta.reshape(1, -1, N), autotune=autotune, lr=lr,
                       max_dw=max_dw, levels=levels, w_max=w_max)
    return gp[0], gm[0]


pulse_update.launches = 0


# ---------------------------------------------------------------------------
# The differentiable crossbar product (the training path)
# ---------------------------------------------------------------------------

class _CrossbarMatmul(torch.autograd.Function):
    """y = x @ (G+ - G-) on the kernels; backward on 8-bit error codes.
    Operands in bf16 or fp32; every product is taken on their fp32
    values, y and dx come back in x's dtype, dw and -dw in the
    conductances' dtypes (the reference's casts)."""

    @staticmethod
    def forward(ctx, x, g_plus, g_minus, error_quant, err_bits):
        ctx.save_for_backward(x, g_plus, g_minus)
        ctx.error_quant, ctx.err_bits = error_quant, err_bits
        return crossbar_fwd(x, g_plus, g_minus,
                            activation=False).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, g_plus, g_minus = ctx.saved_tensors
        if ctx.error_quant:
            # 8-bit sign-magnitude error transport (paper III.F step 1):
            # the codes feed both kernels, dequantized in-kernel.
            qt = q.error_quantize(dy, ctx.err_bits)
            dx = crossbar_bwd(qt.codes, g_plus, g_minus, dy_scale=qt.scale)
            dw = crossbar_dw(x, qt.codes, dy_scale=qt.scale)
        else:
            dx = crossbar_bwd(dy, g_plus, g_minus)
            dw = crossbar_dw(x, dy)
        # d/dg_plus = +dw, d/dg_minus = -dw: the two columns move
        # oppositely (the +dw/2 / -dw/2 hardware update convention).
        return (dx.to(x.dtype), dw.to(g_plus.dtype), (-dw).to(g_minus.dtype),
                None, None)


def crossbar_matmul(x: torch.Tensor, g_plus: torch.Tensor,
                    g_minus: torch.Tensor, *, error_quant: bool = False,
                    err_bits: int = 8) -> torch.Tensor:
    """Differentiable y = x @ (G+ - G-) on the kernel path.

    Forward runs the fwd kernel; ``backward`` runs the bwd + dw kernels with
    the incoming error optionally quantized to ``err_bits`` sign-magnitude
    codes (dequantized in-kernel) — the same semantics as the reference
    ``core.crossbar._xbar_matmul`` VJP."""
    return _CrossbarMatmul.apply(x, g_plus, g_minus, error_quant, err_bits)


# ---------------------------------------------------------------------------
# Stacked (multicore) entry points — the virtual chip's execution engine
# ---------------------------------------------------------------------------
# A pipeline stage holds T physical cores as stacked conductances
# (T, rows, cols); all cores of a stage run as ONE launch over the core
# axis.  Every stacked entry point also accepts one extra leading chip axis
# — (C, T, M, K) instead of (T, M, K) — which folds into the core stack.

def _fold_chip_axis(*arrays):
    """Fold an optional leading chip axis into the core-stack axis.

    All arrays must share ndim (3 = no chip axis, 4 = (C, T, ...)).
    Returns (folded_arrays, unfold) where ``unfold(y)`` restores the chip
    axis on a (C*T, ...) result."""
    ndims = {a.dim() for a in arrays}
    if ndims == {3}:
        return arrays, lambda y: y
    if ndims != {4}:
        raise ValueError(f"stacked operands must all be rank 3 or all "
                         f"rank 4, got ndims {sorted(ndims)}")
    C = arrays[0].shape[0]
    if any(a.shape[0] != C for a in arrays):
        raise ValueError("mismatched chip axis across stacked operands")
    folded = tuple(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
                   for a in arrays)
    return folded, lambda y: y.reshape((C, y.shape[0] // C) + y.shape[1:])


def _chips(a: torch.Tensor) -> int | None:
    """The chip count a stacked operand folds into its core stack (its
    leading axis when rank 4), None without a chip axis: the autotuner's
    ``fold``."""
    return a.shape[0] if a.dim() == 4 else None


def crossbar_fwd_stacked(xs: torch.Tensor, g_plus: torch.Tensor,
                         g_minus: torch.Tensor, *, activation: bool = False,
                         adc_bits: int | None = None,
                         adc_range: float = 0.5,
                         autotune: bool | None = None) -> torch.Tensor:
    """Batched multi-core forward: one launch evaluates T crossbars.

    xs (T, M, K); g± (T, K, N) -> (T, M, N).  Core t computes
    ``xs[t] @ (g_plus[t] - g_minus[t])`` — the per-stage dispatch of the
    virtual chip, where slice t is one physical core's conductance array.
    A leading chip axis — xs (C, T, M, K); g± (C, T, K, N) — folds into the
    core stack, so a whole farm executes as the same single launch.
    ``autotune`` as in :func:`block_config` (the chip count is its
    ``fold``).
    """
    fold = _chips(xs)
    (xs, g_plus, g_minus), unfold = _fold_chip_axis(xs, g_plus, g_minus)
    return unfold(_dispatch(crossbar_fwd_stacked, "crossbar_fwd",
                            "fwd_stacked", xs, g_plus, g_minus, fold=fold,
                            autotune=autotune, activation=activation,
                            adc_bits=adc_bits, adc_range=adc_range))


crossbar_fwd_stacked.launches = 0


def crossbar_bwd_stacked(dys: torch.Tensor, g_plus: torch.Tensor,
                         g_minus: torch.Tensor, *,
                         dy_scale: torch.Tensor | None = None,
                         autotune: bool | None = None) -> torch.Tensor:
    """Batched multi-core error backprop: dx[t] = dys[t] @ (G+ - G-)[t]^T.

    dys (T, M, N); g± (T, K, N) -> (T, M, K).  The virtual chip drives each
    core's error through its own conductances (Eq. 7 / Fig. 9), all cores
    of a stage in one launch.  A leading chip axis folds like
    :func:`crossbar_fwd_stacked`; ``dy_scale`` as in :func:`crossbar_bwd`.
    """
    fold = _chips(dys)
    (dys, g_plus, g_minus), unfold = _fold_chip_axis(dys, g_plus, g_minus)
    return unfold(_dispatch(crossbar_bwd_stacked, "crossbar_bwd",
                            "bwd_stacked", dys, g_plus, g_minus, fold=fold,
                            autotune=autotune, dy_scale=dy_scale))


crossbar_bwd_stacked.launches = 0


def crossbar_dw_stacked(xs: torch.Tensor, dys: torch.Tensor, *,
                        dy_scale: torch.Tensor | None = None,
                        autotune: bool | None = None) -> torch.Tensor:
    """Batched multi-core weight gradient: dw[t] = xs[t]^T @ dys[t]
    (batch-summed outer products, the paper's Eq. 6 per core).

    xs (T, M, K); dys (T, M, N) -> (T, K, N).  A leading chip axis folds
    like :func:`crossbar_fwd_stacked`."""
    fold = _chips(xs)
    (xs, dys), unfold = _fold_chip_axis(xs, dys)
    return unfold(_dispatch(crossbar_dw_stacked, "crossbar_dw", "dw_stacked",
                            xs, dys, fold=fold, autotune=autotune,
                            dy_scale=dy_scale))


crossbar_dw_stacked.launches = 0


def pulse_update_stacked(g_plus: torch.Tensor, g_minus: torch.Tensor,
                         xs: torch.Tensor, deltas: torch.Tensor, *,
                         lr: float, max_dw: float = 0.05, levels: int = 128,
                         w_max: float = 1.0, autotune: bool | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-core pulse update (paper III.F step 3) on conductance
    stacks: xs (T, M, K); deltas (T, M, N); g± (T, K, N) -> new stacks.

    Each core's outer product, pulse discretization and clipping run in one
    launch for the whole stage — the virtual chip's update phase.  A
    leading chip axis folds like :func:`crossbar_fwd_stacked` (independent
    per-chip updates)."""
    fold = _chips(xs)
    (g_plus, g_minus, xs, deltas), unfold = _fold_chip_axis(
        g_plus, g_minus, xs, deltas)
    gp, gm = _dispatch(pulse_update_stacked, "pulse_update", "pulse_stacked",
                       g_plus, g_minus, xs, deltas, fold=fold,
                       autotune=autotune, lr=lr, max_dw=max_dw,
                       levels=levels, w_max=w_max)
    return unfold(gp), unfold(gm)


pulse_update_stacked.launches = 0


def crossbar_train_stacked(g_plus: torch.Tensor, g_minus: torch.Tensor,
                           xs: torch.Tensor, deltas: torch.Tensor, *,
                           lr: float | torch.Tensor,
                           dy_scale: torch.Tensor | None = None,
                           max_dw: float = 0.05, levels: int = 128,
                           w_max: float = 1.0, compute_y: bool = False,
                           inplace: bool = False,
                           autotune: bool | None = None
                           ) -> tuple[torch.Tensor, ...]:
    """Fused per-stage training step over a core stack, one launch.

    xs (T, M, K); deltas (T, M, N); g± (T, K, N) ->
        (ys (T, M, N), dxs (T, M, K), g+', g-').

    Runs what the four-call path (`crossbar_fwd_stacked` +
    `crossbar_bwd_stacked` + `crossbar_dw_stacked` + the pulse update)
    launches separately; on the card it equals that sequence bit for bit
    (the kernel sums in the standalone kernels' orders).  ``ys`` is the
    forward product when ``compute_y``, else zeros.  ``dy_scale`` selects
    the 8-bit sign-magnitude error path (codes in ``deltas``, dequantized
    in-kernel).  ``lr`` is a Python float or a one-element fp32 tensor on
    the operands' device, which a CUDA graph reads at replay.  ``inplace``
    copies the new conductances into ``g_plus``/``g_minus`` (the kernel
    itself writes fresh tensors) and returns them.  A leading chip axis
    folds like :func:`crossbar_fwd_stacked`.  This is the compiled training
    step's per-stage body.
    """
    targets = (g_plus, g_minus)
    fold = _chips(xs)
    (g_plus, g_minus, xs, deltas), unfold = _fold_chip_axis(
        g_plus, g_minus, xs, deltas)
    ys, dxs, gp, gm = _dispatch(
        crossbar_train_stacked, "crossbar_train",
        "train_stacked_y" if compute_y else "train_stacked", g_plus,
        g_minus, xs, deltas, fold=fold, autotune=autotune, lr=lr,
        dy_scale=dy_scale, max_dw=max_dw, levels=levels, w_max=w_max,
        compute_y=compute_y)
    gp, gm = unfold(gp), unfold(gm)
    if inplace:
        targets[0].copy_(gp)
        targets[1].copy_(gm)
        gp, gm = targets
    return unfold(ys), unfold(dxs), gp, gm


crossbar_train_stacked.launches = 0


# ---------------------------------------------------------------------------
# The digital clustering core (k-means assignment)
# ---------------------------------------------------------------------------

def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Manhattan assignment.  x (n, d); centers (k, d) -> (n,) int32, ties
    to the lowest index.  Both are taken as fp32; k and d are at most 128
    (raises otherwise).  Any n: the kernel masks the ragged tail, nothing
    is padded."""
    kmk.check_limits(x, centers)
    x, centers = x.to(torch.float32), centers.to(torch.float32)
    if x.is_cpu and centers.is_cpu:
        return run_plain(kmk.kmeans_assign_plain, x, centers)
    # fp32, limits checked: the launch checks only n and the device
    out = kmk.launch(x.contiguous(), centers.contiguous())
    kmeans_assign.launches += 1
    return out


kmeans_assign.launches = 0


# ---------------------------------------------------------------------------
# Attention (the LM's prefill)
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The flash kernel's forward (counted), the plain function's
    vector-Jacobian product as its backward.  Under remat the forward runs
    again when its period is recomputed, and counts again."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, semantics, q_chunk, kv_chunk,
                window=None):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(scale=scale, causal=causal, semantics=semantics,
                      q_chunk=q_chunk, kv_chunk=kv_chunk, window=window)
        out = fak.flash_attention_kernel(q, k, v, scale=scale, causal=causal,
                                         semantics=semantics, window=window)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*fak.flash_attention_vjp(q, k, v, dout, **ctx.kw),
                None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    semantics: str = "pallas", q_chunk: int = 512,
                    kv_chunk: int = 512,
                    window: int | None = None) -> torch.Tensor:
    """Fused attention.  q (B, Sq, H, hd); k, v (B, Skv, K, hd), H % K == 0
    -> (B, Sq, H, hd) in q's dtype.  ``semantics`` selects which of the
    reference's two functions is computed: ``"pallas"`` (its Pallas
    kernel, the default) or ``"chunked"`` (its layer's
    ``chunked_attention``, the LM prefill's; see
    ``kernels/flash_attention.py``).  On CPU tensors the chunked function
    walks the ``q_chunk`` x ``kv_chunk`` grid; the kernel's key tile is 64
    whatever the chunks.  GQA reads kv head h // (H // K) in the kernel
    (nothing is broadcast); the fp32 kernel reads q, k and v through
    their strides, the bf16 one copies a view only where its rows are not
    16-byte aligned.  Any Sq and Skv: the kernels mask the ragged edge,
    nothing is padded.  Each launch is counted on ``launches`` (and by the
    kernel on ``flash_attention_kernel.routes``).  ``window`` (the
    chunked function only, Sq <= Skv) masks key j for query i unless i -
    window < j; both kernels skip the key tiles wholly outside the band.
    Differentiable: on the CPU through the plain version, on the card
    through ``flash_attention_vjp``."""
    fak.check_semantics(semantics)
    fak.check_shapes(q, k, v)
    fak.check_window(window, semantics, q.shape[1], k.shape[1])
    if all(t.device.type == "cpu" for t in (q, k, v)):
        if semantics == "chunked":
            return run_plain(
                fak.chunked_attention_plain, q, k, v, scale=scale,
                causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                window=window)
        return run_plain(fak.flash_attention_plain, q, k, v, scale=scale,
                         causal=causal)
    return _FlashAttention.apply(q, k, v, scale, causal, semantics, q_chunk,
                                 kv_chunk, window)


flash_attention.launches = 0
