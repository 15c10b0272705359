"""Port parity: the training kernels' plain versions (the CPU path of
``repro_torch.kernels.ops``) — error backprop, weight gradient and pulse
update, 2-D, stacked and with a chip axis, fp32 and 8-bit error codes —
against the reference's Pallas kernels, run in interpret mode on CPU as
``tests/test_kernels.py``, ``tests/test_kernel_grads.py`` and
``tests/test_stacked_differential.py`` run them.

Tolerances: fp32 values agree within 1e-5 absolute and relative (the
repo's kernel bar: the two sides sum in different orders, and the Pallas
kernel accumulates per tile).  Pulse counts are compared as integers, read
back from unclipped conductances: a count may differ by one only where the
plain unrounded count 2 lr (x^T d) / u lies within 1e-4 of a half-integer,
and there a conductance may differ by u/2; everywhere else conductances
agree within 1e-6.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as jq  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import crossbar as xbk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATOL = 1e-5
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
MAX_DW, LEVELS = 0.05, 128
UNIT = MAX_DW / LEVELS

SHAPES = [(8, 4, 3), (16, 100, 50), (128, 700, 260), (64, 512, 128),
          (32, 1024, 256), (8, 401, 101)]   # tests/test_kernels.py
GRAD_SHAPES = [(8, 4, 3), (4, 37, 11), (16, 130, 70),
               (8, 512, 128)]               # tests/test_kernel_grads.py
SWEEP = [(1, 1, 8, 4), (3, 2, 37, 11), (5, 3, 37, 11), (2, 16, 128, 32),
         (4, 129, 64, 16), (2, 8, 512, 128),
         (7, 5, 401, 100)]                  # test_stacked_differential.py
CHIP_AXIS = [(2, 3, 2, 37, 11), (3, 2, 4, 64, 16)]


def _rng(seed):
    return np.random.default_rng(seed)


def _data(seed, t_shape, m, k, n, d_scale=0.1, g_lo=0.0, g_hi=1.0):
    """x (.., m, k), d (.., m, n), g± (.., k, n) as float32 numpy."""
    rng = _rng(seed)
    x = (rng.standard_normal(t_shape + (m, k)) * 0.2).astype(np.float32)
    d = (rng.standard_normal(t_shape + (m, n)) * d_scale).astype(np.float32)
    gp = rng.uniform(g_lo, g_hi, t_shape + (k, n)).astype(np.float32)
    gm = rng.uniform(g_lo, g_hi, t_shape + (k, n)).astype(np.float32)
    return x, d, gp, gm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _unrounded_counts(x, d, lr):
    """2 lr (x^T d) / u in float64, over the last two axes."""
    acc = np.einsum("...mk,...mn->...kn", x.astype(np.float64),
                    d.astype(np.float64))
    return 2.0 * lr * acc / UNIT


def assert_pulse_rule(old, got, want, counts):
    """Counts as integers (from unclipped conductances) equal, or one apart
    next to a half-integer of ``counts``; conductances within G_ATOL
    elsewhere and within u/2 there."""
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


# ---------------------------------------------------------------------------
# 2-D wrappers against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_crossbar_bwd_matches_pallas(shape):
    M, K, N = shape
    _, d, gp, gm = _data(M + K, (), M, K, N)
    got = tops.crossbar_bwd(*_t(d, gp, gm))
    ref = jops.crossbar_bwd(jnp.asarray(d), jnp.asarray(gp), jnp.asarray(gm))
    assert tuple(got.shape) == (M, K) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("shape", SHAPES[:4] + [(32, 257, 65)])
def test_crossbar_dw_matches_pallas(shape):
    M, K, N = shape
    x, d, _, _ = _data(M * 3 + N, (), M, K, N)
    got = tops.crossbar_dw(*_t(x, d))
    ref = jops.crossbar_dw(jnp.asarray(x), jnp.asarray(d))
    assert tuple(got.shape) == (K, N)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_pulse_update_matches_pallas(shape):
    M, K, N = shape
    # mid-range conductances: no clipping, so counts read back exactly
    x, d, gp, gm = _data(M + 2 * K, (), M, K, N, g_lo=0.3, g_hi=0.7)
    lr = 0.01
    got = tops.pulse_update(*_t(gp, gm, x, d), lr=lr)
    ref = jops.pulse_update(*map(jnp.asarray, (gp, gm, x, d)), lr=lr)
    assert_pulse_rule((gp, gm), [_np(g) for g in got],
                      [np.asarray(r) for r in ref],
                      _unrounded_counts(x, d, lr))


@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("bits", [8, 12])
def test_error_codes_dequantized_in_kernel_path(shape, bits):
    """int8 (8-bit) and int32 (12-bit) sign-magnitude codes with a 0-d
    scale through bwd and dw == the reference's codes path."""
    M, K, N = shape
    x, d, gp, gm = _data(bits + K, (), M, K, N)
    jt = jq.error_quantize(jnp.asarray(d), bits)
    tt = tq.error_quantize(torch.from_numpy(d), bits)
    np.testing.assert_array_equal(_np(tt.codes), np.asarray(jt.codes))
    assert tt.codes.dtype == (torch.int8 if bits <= 8 else torch.int32)
    got = tops.crossbar_bwd(tt.codes, *_t(gp, gm), dy_scale=tt.scale)
    ref = jops.crossbar_bwd(jt.codes, jnp.asarray(gp), jnp.asarray(gm),
                            dy_scale=jt.scale)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    got = tops.crossbar_dw(torch.from_numpy(x), tt.codes, dy_scale=tt.scale)
    ref = jops.crossbar_dw(jnp.asarray(x), jt.codes, dy_scale=jt.scale)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    # and the codes path equals dequantize-then-product
    np.testing.assert_allclose(
        _np(got), _np(tops.crossbar_dw(torch.from_numpy(x),
                                       tt.dequantize())), atol=ATOL)


def test_leading_axes_and_ref_oracles():
    x, d, gp, gm = _data(5, (2,), 5, 37, 11)
    tx, td, tgp, tgm = _t(x, d, gp[0], gm[0])
    assert tuple(tops.crossbar_bwd(td, tgp, tgm).shape) == (2, 5, 37)
    # dw sums over every leading axis
    np.testing.assert_allclose(
        _np(tops.crossbar_dw(tx, td)),
        np.einsum("abk,abn->kn", x, d), atol=ATOL)
    x2, d2 = x.reshape(-1, 37), d.reshape(-1, 11)
    for got, ref in [
        (tref.crossbar_bwd_ref(*_t(d2, gp[0], gm[0])),
         jref.crossbar_bwd_ref(d2, gp[0], gm[0])),
        (tref.crossbar_dw_ref(*_t(x2, d2)), jref.crossbar_dw_ref(x2, d2)),
    ]:
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
    g0 = (gp[0] * 0.4 + 0.3, gm[0] * 0.4 + 0.3)
    got = tref.pulse_update_ref(*_t(*g0, x2, d2), lr=0.05, max_dw=MAX_DW,
                                levels=LEVELS, w_max=1.0)
    ref = jref.pulse_update_ref(*g0, x2, d2, lr=0.05, max_dw=MAX_DW,
                                levels=LEVELS, w_max=1.0)
    assert_pulse_rule(g0, [_np(g) for g in got], [np.asarray(r) for r in ref],
                      _unrounded_counts(x2, d2, 0.05))


# ---------------------------------------------------------------------------
# Stacked wrappers and the chip axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,m,k,n", SWEEP)
def test_bwd_stacked_matches_pallas_and_per_core(t, m, k, n):
    _, d, gp, gm = _data(t * 2000 + n, (t,), m, k, n)
    got = tops.crossbar_bwd_stacked(*_t(d, gp, gm))
    ref = jops.crossbar_bwd_stacked(*map(jnp.asarray, (d, gp, gm)))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    per_core = torch.stack([tops.crossbar_bwd(*_t(d[i], gp[i], gm[i]))
                            for i in range(t)])
    assert torch.equal(got, per_core)


@pytest.mark.parametrize("t,m,k,n", SWEEP[:5])
def test_dw_stacked_matches_pallas_and_per_core(t, m, k, n):
    x, d, _, _ = _data(t * 3000 + k, (t,), m, k, n)
    got = tops.crossbar_dw_stacked(*_t(x, d))
    ref = jops.crossbar_dw_stacked(jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
    per_core = torch.stack([tops.crossbar_dw(*_t(x[i], d[i]))
                            for i in range(t)])
    assert torch.equal(got, per_core)


@pytest.mark.parametrize("t,m,k,n", SWEEP)
def test_pulse_stacked_matches_pallas(t, m, k, n):
    x, d, gp, gm = _data(t * 4000 + m, (t,), m, k, n, g_lo=0.3, g_hi=0.7)
    lr = 0.05
    got = tops.pulse_update_stacked(*_t(gp, gm, x, d), lr=lr)
    ref = jops.pulse_update_stacked(*map(jnp.asarray, (gp, gm, x, d)),
                                    lr=lr)
    assert_pulse_rule((gp, gm), [_np(g) for g in got],
                      [np.asarray(r) for r in ref],
                      _unrounded_counts(x, d, lr))


@pytest.mark.parametrize("c,t,m,k,n", CHIP_AXIS)
def test_chip_axis_matches_pallas(c, t, m, k, n):
    x, d, gp, gm = _data(c * 10 + t, (c, t), m, k, n, g_lo=0.2, g_hi=0.8)
    jx, jd, jgp, jgm = map(jnp.asarray, (x, d, gp, gm))
    tx, td, tgp, tgm = _t(x, d, gp, gm)
    np.testing.assert_allclose(
        _np(tops.crossbar_bwd_stacked(td, tgp, tgm)),
        np.asarray(jops.crossbar_bwd_stacked(jd, jgp, jgm)), atol=ATOL,
        rtol=ATOL)
    np.testing.assert_allclose(
        _np(tops.crossbar_dw_stacked(tx, td)),
        np.asarray(jops.crossbar_dw_stacked(jx, jd)), atol=ATOL, rtol=ATOL)
    got = tops.pulse_update_stacked(tgp, tgm, tx, td, lr=0.05)
    ref = jops.pulse_update_stacked(jgp, jgm, jx, jd, lr=0.05)
    assert tuple(got[0].shape) == (c, t, k, n)
    assert_pulse_rule((gp, gm), [_np(g) for g in got],
                      [np.asarray(r) for r in ref],
                      _unrounded_counts(x, d, 0.05))
    # the chip axis is a batching axis: equal to a loop over chips
    for i in range(c):
        per = tops.pulse_update_stacked(tgp[i], tgm[i], tx[i], td[i],
                                        lr=0.05)
        assert torch.equal(got[0][i], per[0])
        assert torch.equal(got[1][i], per[1])


def test_codes_through_stacked_wrappers_with_chip_axis():
    x, d, gp, gm = _data(21, (2, 3), 6, 45, 13)
    jt = jq.error_quantize(jnp.asarray(d), 8)
    tt = tq.error_quantize(torch.from_numpy(d), 8)
    np.testing.assert_allclose(
        _np(tops.crossbar_bwd_stacked(tt.codes, *_t(gp, gm),
                                      dy_scale=tt.scale)),
        np.asarray(jops.crossbar_bwd_stacked(jt.dequantize(),
                                             jnp.asarray(gp),
                                             jnp.asarray(gm))),
        atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        _np(tops.crossbar_dw_stacked(torch.from_numpy(x), tt.codes,
                                     dy_scale=tt.scale)),
        np.asarray(jops.crossbar_dw_stacked(jnp.asarray(x),
                                            jt.dequantize())),
        atol=ATOL, rtol=ATOL)


def test_padding_lines_stay_zero():
    """A stage stack's bias line (row 0 of fan-in tile 0) and its pad rows
    and columns see zero inputs or zero errors: their update is 0 and their
    conductances stay 0, as on the chip."""
    from repro_torch.core.mapping import map_network
    from repro_torch.sim.chip import _tile_cols
    from repro_torch.sim.placer import _untile, place_layer, tile_inputs
    rng = _rng(4)
    rows, cols, F, O = 16, 8, 20, 13       # 2 fan-in x 2 fan-out tiles
    lm = map_network([F, O], rows, cols).layers[0]
    layer = {k: torch.from_numpy(rng.uniform(0.3, 0.7, (F, O))
                                 .astype(np.float32))
             for k in ("g_plus", "g_minus")}
    st = place_layer(0, layer, lm, rows, cols)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (5, F)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((5, O)).astype(np.float32))
    xs = tile_inputs(x, 2, 2, rows)
    ds = _tile_cols(d, 2, 2, cols)
    new = tops.pulse_update_stacked(st.g_plus, st.g_minus, xs, ds, lr=0.5)
    for g_new, g_old in zip(new, (layer["g_plus"], layer["g_minus"])):
        full = _untile(g_new, 2, 2, rows, cols)
        pad = torch.ones_like(full, dtype=torch.bool)
        pad[1:F + 1, :O] = False
        assert torch.all(full[pad] == 0)
        assert not torch.equal(full[1:F + 1, :O], g_old)   # real lines moved


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_path_counts_no_launch():
    names = ("crossbar_bwd", "crossbar_dw", "pulse_update",
             "crossbar_bwd_stacked", "crossbar_dw_stacked",
             "pulse_update_stacked")
    before = [getattr(tops, n).launches for n in names]
    x, d, gp, gm = _t(*_data(1, (2,), 3, 8, 4))
    tops.crossbar_bwd_stacked(d, gp, gm)
    tops.crossbar_dw_stacked(x, d)
    tops.pulse_update_stacked(gp, gm, x, d, lr=0.1)
    tops.crossbar_bwd(d[0], gp[0], gm[0])
    tops.crossbar_dw(x[0], d[0])
    tops.pulse_update(gp[0], gm[0], x[0], d[0], lr=0.1)
    assert [getattr(tops, n).launches for n in names] == before


@pytest.mark.parametrize("launch", [
    lambda x, d, gp, gm: xbk.crossbar_bwd_kernel(d, gp, gm),
    lambda x, d, gp, gm: xbk.crossbar_dw_kernel(x, d),
    lambda x, d, gp, gm: xbk.pulse_update_kernel(gp, gm, x, d, lr=0.1),
])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    # the launchers never fall back: a tensor they cannot launch on raises
    with pytest.raises(ValueError, match="CUDA"):
        launch(*_t(*_data(2, (1,), 3, 8, 4)))


def test_codes_need_a_scale_and_only_codes_take_one(monkeypatch):
    # on the CPU the device check would raise first: keep only its dtype rule
    def dtype_only(name, t, like, dtypes=(torch.float32,)):
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {t.dtype}")
    monkeypatch.setattr(xbk, "_check_operand", dtype_only)
    d = torch.zeros(1, 3, 4)
    assert xbk._dy_kind(d, None) == 0
    assert xbk._dy_kind(d.to(torch.int8), torch.ones(())) == 1
    assert xbk._dy_kind(d.to(torch.int32), torch.ones(())) == 2
    with pytest.raises(ValueError, match="dy_scale"):
        xbk._dy_kind(d, torch.ones(()))
    with pytest.raises(ValueError, match="dy_scale"):
        xbk._dy_kind(d.to(torch.int8), None)
    with pytest.raises(ValueError, match="dy_scale"):
        xbk._dy_kind(d.to(torch.int8), torch.ones(2))
    with pytest.raises(TypeError):
        xbk._dy_kind(d.to(torch.int16), torch.ones(()))


def test_stacked_rejects_mixed_ranks():
    x = torch.zeros(2, 3, 4, 5)
    g = torch.zeros(3, 5, 2)
    with pytest.raises(ValueError):
        tops.crossbar_bwd_stacked(x, g, g)
    with pytest.raises(ValueError):
        tops.pulse_update_stacked(g, g, x, x, lr=0.1)


def test_cuda_sources_reduce_without_atomics_or_library_calls():
    """Each training kernel is its own CUDA C++ source for sm_90a, with the
    headers under ``csrc/`` that it includes: no atomics (every output is
    one thread's ordered sum), no cuBLAS and no finished kernel, no
    fast-math build flag."""
    import re
    from repro_torch.kernels import _build
    for name in ("crossbar_fwd", "crossbar_bwd", "crossbar_dw",
                 "pulse_update"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        text += "".join((_build.CSRC / h).read_text() for h in
                        re.findall(r'#include "([\w.]+)"', text))
        src = "\n".join(line.split("//")[0] for line in text.splitlines())
        assert f'extern "C" int {name}_launch(' in src
        for banned in ("atomic", "cublas", "cutlass", "#include <torch"):
            assert banned not in src.lower(), (name, banned)
        assert "fmaf(" in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
