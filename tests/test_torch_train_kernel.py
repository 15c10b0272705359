"""Port parity: the fused per-stage training step
``repro_torch.kernels.ops.crossbar_train_stacked`` (on CPU, its plain
version) against the reference's ``kernels.ops.crossbar_train_stacked``
(the Pallas ``crossbar_train_kernel`` in interpret mode), on the shapes of
``tests/test_compiled_step.py``'s megakernel sweep: ragged stacks with
zeroed trailing cores, 8-bit sign-magnitude error codes, and a chip axis.

Tolerances: ``ys`` and ``dxs`` within 1e-5 absolute and relative (the
repo's kernel bar: the sums run in other orders); pulse counts compared as
integers read back from unclipped conductances, one apart only where the
unrounded count 2 lr (x^T d) / u lies within 1e-4 of a half-integer, with
the conductances there within u/2 and everywhere else within 1e-6.  The
CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it bit
for bit against the four-call sequence there).

Also here: the cached device constants of ``core.quantization`` and
``kernels.crossbar`` give the values the per-call constants gave.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import crossbar as xbk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
MAX_DW, LEVELS, W_MAX = 0.05, 128, 1.0
UNIT = MAX_DW / LEVELS
LR = 0.05

# tests/test_compiled_step.py::test_megakernel_matches_four_call_bitwise
MEGA_CASES = [
    (1, 2, 17, 9, None, 0),
    (3, 4, 41, 15, None, 0),
    (4, 2, 400, 100, None, 2),          # paper core geometry, ragged stack
    (3, 4, 41, 15, 8, 0),               # sign-magnitude error codes
    (5, 3, 129, 101, 8, 3),             # ragged + codes
]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _stack(T, M, K, N, seed, ragged=0, lead=()):
    """g± in [0.1, 0.9], x ~ N(0, 1), d ~ N(0, 0.04) as float32 numpy;
    ``ragged`` trailing cores zeroed (the StageStacks envelope)."""
    rng = np.random.default_rng(seed)
    gp = rng.uniform(0.1, 0.9, lead + (T, K, N)).astype(np.float32)
    gm = rng.uniform(0.1, 0.9, lead + (T, K, N)).astype(np.float32)
    xs = rng.standard_normal(lead + (T, M, K)).astype(np.float32)
    ds = (rng.standard_normal(lead + (T, M, N)) * 0.2).astype(np.float32)
    if ragged:
        for a in (gp, gm, xs, ds):
            a[..., T - ragged:, :, :] = 0.0
    return gp, gm, xs, ds


def _counts(xs, d):
    acc = np.einsum("...mk,...mn->...kn", xs.astype(np.float64),
                    d.astype(np.float64))
    return 2.0 * LR * acc / UNIT


def assert_pulse_rule(old, got, want, counts):
    near = np.abs(counts - np.floor(counts) - 0.5) < PULSE_BOUNDARY
    for g0, g, w in zip(old, got, want):
        kc = np.rint((g - g0) / (UNIT / 2))
        pc = np.rint((w - g0) / (UNIT / 2))
        diff = np.abs(kc - pc)
        assert diff.max(initial=0) <= 1
        assert not np.any((diff > 0) & ~near), np.argwhere((diff > 0) & ~near)
        d = np.abs(g - w)
        assert np.all(d[~near] <= G_ATOL), d[~near].max()
        assert np.all(d[near] <= UNIT / 2 + G_ATOL)


def _both(gp, gm, xs, ds, err_bits=None, compute_y=True):
    """(reference outputs, port outputs, dequantized d) on the same data;
    with ``err_bits`` both sides get the reference's codes and scale."""
    scale = t_scale = None
    t_ds = torch.from_numpy(ds)
    if err_bits is not None:
        qt = jq.error_quantize(jnp.asarray(ds), err_bits)
        codes = np.asarray(qt.codes)
        ds = codes.astype(np.float32)       # the reference takes fp32 codes
        scale = qt.scale
        t_ds = torch.from_numpy(codes.astype(np.int8))
        t_scale = torch.tensor(float(np.asarray(scale)), dtype=torch.float32)
    rule = dict(lr=LR, max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX,
                compute_y=compute_y)
    ref = jops.crossbar_train_stacked(gp, gm, xs, ds, dy_scale=scale, **rule)
    got = tops.crossbar_train_stacked(
        torch.from_numpy(gp), torch.from_numpy(gm), torch.from_numpy(xs),
        t_ds, dy_scale=t_scale, **rule)
    d = ds if scale is None else ds * np.float32(np.asarray(scale))
    return [np.asarray(a) for a in ref], [_np(a) for a in got], d


@pytest.mark.parametrize("T,M,K,N,err_bits,ragged", MEGA_CASES)
def test_train_stacked_matches_pallas(T, M, K, N, err_bits, ragged):
    gp, gm, xs, ds = _stack(T, M, K, N, seed=7 + T, ragged=ragged)
    (ry, rdx, rgp, rgm), (ty, tdx, tgp, tgm), d = _both(
        gp, gm, xs, ds, err_bits)
    np.testing.assert_allclose(ty, ry, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tdx, rdx, atol=ATOL, rtol=ATOL)
    assert_pulse_rule((gp, gm), (tgp, tgm), (rgp, rgm), _counts(xs, d))
    if ragged:   # zero cores stay exactly zero
        for a in (ty, tdx, tgp, tgm):
            assert not np.any(a[T - ragged:])


def test_train_stacked_chip_axis_matches_pallas():
    gp, gm, xs, ds = _stack(3, 4, 41, 15, seed=11, ragged=1, lead=(2,))
    (ry, rdx, rgp, rgm), (ty, tdx, tgp, tgm), d = _both(gp, gm, xs, ds, 8)
    assert ty.shape == (2, 3, 4, 15) and tdx.shape == (2, 3, 4, 41)
    np.testing.assert_allclose(ty, ry, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tdx, rdx, atol=ATOL, rtol=ATOL)
    assert_pulse_rule((gp, gm), (tgp, tgm), (rgp, rgm), _counts(xs, d))
    # the fold is per core: each chip equals its own unfolded stack
    for c in range(2):
        one = tops.crossbar_train_stacked(
            *(torch.from_numpy(a[c]) for a in (gp, gm, xs, d)), lr=LR,
            compute_y=True)
        for a, b in zip(one, (ty, tdx, tgp, tgm)):
            np.testing.assert_array_equal(_np(a), b[c])


def test_compute_y_off_gives_zero_ys_and_same_update():
    gp, gm, xs, ds = _stack(2, 3, 17, 9, seed=0)
    (ry, _, _, _), (ty, tdx, tgp, tgm), _ = _both(gp, gm, xs, ds,
                                                  compute_y=False)
    assert ty.shape == (2, 3, 9) and not np.any(ty)
    assert not np.any(ry)
    _, (_, tdx_y, tgp_y, tgm_y), _ = _both(gp, gm, xs, ds, compute_y=True)
    for a, b in ((tdx, tdx_y), (tgp, tgp_y), (tgm, tgm_y)):
        np.testing.assert_array_equal(a, b)


def test_train_plain_equals_the_four_call_sequence():
    """The plain version is the four plain calls (fwd without activation,
    bwd, pulse update on the dequantized error), value for value."""
    gp, gm, xs, _ = (torch.from_numpy(a) for a in _stack(3, 5, 41, 15, 3))
    codes = torch.randint(-127, 128, (3, 5, 15),
                          generator=torch.Generator().manual_seed(1),
                          dtype=torch.int8)
    scale = torch.tensor(0.013, dtype=torch.float32)
    d = codes.to(torch.float32) * scale
    ys, dxs, gp2, gm2 = xbk.crossbar_train_plain(
        gp, gm, xs, codes, lr=LR, dy_scale=scale, compute_y=True)
    assert torch.equal(ys, xbk.crossbar_fwd_plain(xs, gp, gm,
                                                  activation=False))
    assert torch.equal(dxs, xbk.crossbar_bwd_plain(d, gp, gm))
    want = xbk.pulse_update_plain(gp, gm, xs, d, lr=LR)
    assert torch.equal(gp2, want[0]) and torch.equal(gm2, want[1])


def test_lr_as_device_buffer_equals_lr_as_float():
    """A one-element fp32 ``lr`` (the compiled step's replayable buffer)
    gives the float ``lr``'s update: fp32(2 lr) either way."""
    gp, gm, xs, ds = (torch.from_numpy(a) for a in _stack(2, 7, 33, 12, 5))
    for lr in (0.1 / 7, 0.37 / 4096, 1.0 / 3):
        a = tops.crossbar_train_stacked(gp, gm, xs, ds, lr=lr)
        b = tops.crossbar_train_stacked(
            gp, gm, xs, ds, lr=torch.full((1,), lr, dtype=torch.float32))
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_inplace_writes_into_the_given_stacks():
    gp, gm, xs, ds = (torch.from_numpy(a) for a in _stack(2, 4, 33, 12, 6,
                                                          lead=(2,)))
    want = tops.crossbar_train_stacked(gp, gm, xs, ds, lr=LR,
                                       compute_y=True)
    ptrs = (gp.data_ptr(), gm.data_ptr())
    got = tops.crossbar_train_stacked(gp, gm, xs, ds, lr=LR, inplace=True,
                                      compute_y=True)
    assert (got[2].data_ptr(), got[3].data_ptr()) == ptrs
    assert torch.equal(gp, want[2]) and torch.equal(gm, want[3])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a strided view is written through as well
    nxt = tops.crossbar_train_stacked(gp, gm, xs, ds, lr=LR)
    big = torch.zeros((2,) + gp.shape[:-1] + (2 * gp.shape[-1],))
    views = big[0, ..., ::2], big[1, ..., ::2]
    views[0].copy_(gp)
    views[1].copy_(gm)
    assert not views[0].is_contiguous()
    tops.crossbar_train_stacked(*views, xs, ds, lr=LR, inplace=True)
    assert torch.equal(views[0], nxt[2]) and torch.equal(views[1], nxt[3])


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_path_counts_no_launch():
    before = tops.crossbar_train_stacked.launches
    gp, gm, xs, ds = (torch.from_numpy(a) for a in _stack(2, 3, 17, 9, 1))
    tops.crossbar_train_stacked(gp, gm, xs, ds, lr=LR)
    tops.crossbar_train_stacked(gp[None], gm[None], xs[None], ds[None],
                                lr=LR, compute_y=True)
    assert tops.crossbar_train_stacked.launches == before


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """A tensor off the CPU never takes the plain version: the launcher
    refuses what it cannot launch on (here meta tensors), and nothing is
    counted."""
    before = tops.crossbar_train_stacked.launches
    meta = [torch.empty(s, device="meta") for s in
            ((2, 17, 9), (2, 17, 9), (2, 3, 17), (2, 3, 9))]
    with pytest.raises(ValueError, match="CUDA"):
        tops.crossbar_train_stacked(*meta, lr=LR)
    # a device lr alone also sends the call to the kernel
    cpu = [torch.zeros(m.shape) for m in meta]
    with pytest.raises(ValueError, match="CUDA"):
        tops.crossbar_train_stacked(
            *cpu, lr=torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        xbk.crossbar_train_kernel(*cpu, lr=LR)
    assert tops.crossbar_train_stacked.launches == before


def test_cuda_source_reduces_without_atomics_or_library_calls():
    """The fused kernel is its own CUDA C++ source for sm_90a, with the
    headers under ``csrc/`` that it includes (the update walk of
    ``outer_product.cuh``, the dx and y walks of ``row_product.cuh``): no
    atomics, no cuBLAS or finished kernel, no fast-math; its C entry point
    matches the launcher's argument list."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / "crossbar_train.cu").read_text()
    headers = re.findall(r'#include "([\w.]+)"', text)
    assert headers == ["outer_product.cuh", "row_product.cuh"]
    text += "".join((_build.CSRC / h).read_text() for h in headers)
    src = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert 'extern "C" int crossbar_train_launch(' in src
    for banned in ("atomic", "cublas", "cutlass", "#include <torch"):
        assert banned not in src.lower(), banned
    for needed in ("fmaf(", "__fdiv_rn(", "rintf(", "__fmul_rn(2.f, *lr)",
                   "outer_product::batch_walk<U, TD>",
                   "row_product::dx_walk<R, TD>",
                   "row_product::fwd_walk<R>"):
        assert needed in src, needed
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    head = src.split('extern "C" int crossbar_train_launch(')[1]
    # the 22 argtypes _launch_fn declares: 4 pointers, d_kind, 6 pointers,
    # T, M, K, N, compute_y, tile, dx_run, unit, levels, w_max, stream
    assert head.split(")")[0].count(",") + 1 == 22


# ---------------------------------------------------------------------------
# Section 0: cached device constants
# ---------------------------------------------------------------------------

def test_cached_constants_give_the_per_call_values():
    """``adc_quantize``, ``pulse_discretize`` and the plain pulse update
    with their constants cached equal the same expressions with a fresh
    0-d tensor made on every call (the form before the cache), bit for
    bit; the constant is made once and reused."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.6, 0.6, (64, 33)).astype(np.float32))
    scale = 1.0 / 7
    fresh = torch.tensor(scale, dtype=torch.float32)
    q = torch.round((torch.clamp(x, -0.5, 0.5) + 0.5) / fresh)
    assert torch.equal(tq.adc_quantize(x), q * scale - 0.5)
    dw = x * 0.01
    fresh_u = torch.tensor(MAX_DW / LEVELS, dtype=torch.float32)
    want = torch.clamp(torch.round(dw / fresh_u), -LEVELS, LEVELS) \
        * (MAX_DW / LEVELS)
    assert torch.equal(tq.pulse_discretize(dw, MAX_DW, LEVELS), want)
    gp, gm, xs, ds = (torch.from_numpy(a) for a in _stack(2, 5, 33, 12, 9))
    acc = torch.matmul(xs.transpose(-1, -2), ds)
    counts = torch.tensor(2.0 * LR, dtype=torch.float32) * acc / fresh_u
    half = 0.5 * (torch.clamp(torch.round(counts), -LEVELS, LEVELS)
                  * fresh_u)
    got = xbk.pulse_update_plain(gp, gm, xs, ds, lr=LR)
    assert torch.equal(got[0], torch.clamp(gp + half, 0.0, W_MAX))
    assert torch.equal(got[1], torch.clamp(gm - half, 0.0, W_MAX))
    a = tq.device_constant(scale, torch.float32, torch.device("cpu"))
    assert a is tq._scalar(scale, x) and a is xbk._f32(scale, x)
