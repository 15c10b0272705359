"""Port parity: ``repro_torch.sim.VirtualChip`` (on CPU, where every stage
runs the crossbar kernel's plain version) against ``repro.sim.VirtualChip``
on the same conductances, carried across with ``repro_torch.interop``.

Cases: kdd_anomaly (41-15-41), the small 16x8 grid (20-10-5, forcing the
Fig.-14 aggregation stage) and mnist_class at full width (784-300-200-100-10,
13 cores).  Tolerances: fp32 values within 1e-5 (the repo's kernel bar; the
sums run in different orders); counters, NoC records and report fields
exactly equal, and ``compare_hw`` within 1 %.  Quantized stage inputs are
compared as 3-bit codes rint((a + 0.5) * 7): a code may differ only where
the reference's value before the ADC lies within 1e-6 of a half-step
boundary, and a sample past such a flip is excused downstream of it.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb, hw_model as jhw  # noqa: E402
from repro.sim import VirtualChip as JaxChip  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb, hw_model as thw  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402

ATOL = 1e-5
BOUNDARY = 1e-6
SCALE3 = 1.0 / 7

CASES = {
    "kdd_anomaly": dict(dims=[41, 15, 41], seed=0, n=4, grid={}),
    "small_grid": dict(dims=[20, 10, 5], seed=3, n=3,
                       grid=dict(rows=16, cols=8)),
    "mnist_class": dict(dims=[784, 300, 200, 100, 10], seed=0, n=2,
                        grid={}),
}


def _jax_layers(dims, seed):
    key = jax.random.PRNGKey(seed)
    return [jxb.init_conductances(jax.random.fold_in(key, i), f, o,
                                  japps.PAPER_SPEC)
            for i, (f, o) in enumerate(zip(dims, dims[1:]))]


def _x(dims, n, seed=9):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n, dims[0])).astype(np.float32)


def _chips(name, **kw):
    c = CASES[name]
    jl = _jax_layers(c["dims"], c["seed"])
    np_layers = [{k: np.asarray(v) for k, v in p.items()} for p in jl]
    jchip = JaxChip(jl, japps.PAPER_SPEC, name=name, **c["grid"], **kw)
    tchip = VirtualChip(interop.layers_from_numpy(np_layers, "cpu"),
                        tapps.PAPER_SPEC, name=name, device="cpu",
                        **c["grid"], **kw)
    return jchip, tchip, np_layers, _x(c["dims"], c["n"])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _hold_wave(t_acts, t_dps, t_out, j_acts, j_dps, j_out):
    """Stage-by-stage comparison; returns the samples excused by a
    boundary code flip (none expected, but allowed by the module rule)."""
    M = _np(j_out).shape[0]
    flipped = np.zeros(M, bool)
    for s in range(len(j_dps)):
        ta, ja = _np(t_acts[s]), _np(j_acts[s])
        if s == 0:
            np.testing.assert_array_equal(ta, ja)       # DAC-driven input
        else:
            pre = np.clip(_np(j_dps[s - 1]) * 0.25, -0.5, 0.5)
            u = (pre + 0.5) / SCALE3
            diff = np.rint(ta / SCALE3 + 3.5) != np.rint(ja / SCALE3 + 3.5)
            diff &= ~flipped[:, None]
            near = np.abs(u - np.floor(u) - 0.5) * SCALE3 < BOUNDARY
            assert not np.any(diff & ~near), (s, np.argwhere(diff & ~near))
            flipped |= diff.any(axis=1)
        ok = ~flipped
        np.testing.assert_allclose(_np(t_acts[s])[ok], ja[ok], atol=ATOL)
        np.testing.assert_allclose(_np(t_dps[s])[ok], _np(j_dps[s])[ok],
                                   atol=ATOL)
    ok = ~flipped
    np.testing.assert_allclose(_np(t_out)[ok], _np(j_out)[ok], atol=ATOL)
    return flipped


def _counters(c):
    return (c.samples, dict(c.slots), dict(c.core_steps), c.io_bits,
            c.noc.slot_cycles,
            [dataclasses.astuple(r) for r in c.noc.records])


@pytest.mark.parametrize("name", sorted(CASES))
def test_placement_matches_reference(name):
    jchip, tchip, np_layers, _ = _chips(name)
    assert tchip.placement.dims == jchip.placement.dims
    assert tchip.placement.n_cores == jchip.placement.n_cores
    for ts, js in zip(tchip.placement.stages, jchip.placement.stages):
        assert (ts.index, ts.row_tiles, ts.col_tiles, ts.n_cores) == \
            (js.index, js.row_tiles, js.col_tiles, js.n_cores)
        for k in ("g_plus", "g_minus", "agg_plus", "agg_minus"):
            a, b = getattr(ts, k), getattr(js, k)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(_np(a), np.asarray(b))
    # extract_params round-trips the conductances exactly
    for got, want, ref in zip(interop.layers_to_numpy(tchip.layers()),
                              np_layers, jchip.layers()):
        for k in ("g_plus", "g_minus"):
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_wave_matches_reference(name):
    jchip, tchip, _, x = _chips(name)
    j = jchip.forward_wave(x)
    t = tchip.forward_wave(x)
    _hold_wave(*t, *j)
    assert _counters(tchip.infer_counters) == \
        _counters(jchip.infer_counters)
    jt = jchip.forward_wave(x, count=False, quantize_tail=True)
    tt = tchip.forward_wave(x, count=False, quantize_tail=True)
    pre = np.clip(_np(jt[1][-1]) * 0.25, -0.5, 0.5)
    u = (pre + 0.5) / SCALE3
    diff = np.rint(_np(tt[2]) / SCALE3) != np.rint(np.asarray(jt[2]) / SCALE3)
    # tail codes may differ only next to a half-step boundary (module doc)
    assert not np.any(diff & ~(np.abs(u - np.floor(u) - 0.5) * SCALE3
                               < BOUNDARY))


@pytest.mark.parametrize("name", sorted(CASES))
def test_infer_stream_outputs_stats_counters_report(name):
    jchip, tchip, _, x = _chips(name)
    jout, jstats = jchip.infer_stream(x)
    tout, tstats = tchip.infer_stream(torch.from_numpy(x))
    assert tstats == jstats
    # one more wave on each, through infer with a 1-D sample
    np.testing.assert_allclose(_np(tchip.infer(x[0])),
                               np.asarray(jchip.infer(x[0])), atol=ATOL)
    acts, dps, out = jchip.forward_wave(x, count=False)
    tacts, tdps, _ = tchip.forward_wave(x, count=False)
    _hold_wave(tacts, tdps, tout, acts, dps, jout)
    assert _counters(tchip.infer_counters) == \
        _counters(jchip.infer_counters)
    trep, jrep = tchip.report(), jchip.report()
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    dims = list(jchip.placement.dims)
    cost = thw.network_cost(name, dims, rows=jchip.placement.rows,
                            cols=jchip.placement.cols)
    got = trep.compare_hw(cost)
    assert got == jrep.compare_hw(jhw.network_cost(
        name, dims, rows=jchip.placement.rows, cols=jchip.placement.cols))
    assert set(got) == {"infer_time", "infer_energy", "infer_io"}
    assert all(v <= 0.01 for v in got.values()), got
    assert tchip.beat_us == jchip.beat_us


def test_shared_small_layers_placement_and_report():
    jchip, tchip, _, x = _chips("kdd_anomaly", share_small_layers=True)
    assert tchip.placement.n_cores == jchip.placement.n_cores == 1
    np.testing.assert_allclose(_np(tchip.infer(x)),
                               np.asarray(jchip.infer(x)), atol=ATOL)
    cost = thw.network_cost("kdd_anomaly", [41, 15, 41],
                            share_small_layers=True)
    assert dataclasses.asdict(tchip.report()) == \
        dataclasses.asdict(jchip.report())
    assert all(v <= 0.01 for v in tchip.report().compare_hw(cost).values())


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlp_forward_matches_reference(name, use_kernel):
    c = CASES[name]
    jl = _jax_layers(c["dims"], c["seed"])
    x = _x(c["dims"], c["n"])
    spec_j = dataclasses.replace(japps.PAPER_SPEC, **c["grid"])
    spec_t = dataclasses.replace(tapps.PAPER_SPEC, **c["grid"])
    ref = np.asarray(jxb.mlp_forward(jl, x, spec_j, use_kernel=use_kernel))
    tl = interop.layers_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jl], "cpu")
    got = txb.mlp_forward(tl, x, spec_t, use_kernel=use_kernel,
                          device="cpu")
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)
    # the chip computes the same network
    chip = VirtualChip(tl, spec_t, device="cpu", **c["grid"])
    np.testing.assert_allclose(_np(chip.infer(x)), ref, atol=ATOL)


def test_split_activation_crossbar_apply_matches_reference():
    spec_j = dataclasses.replace(japps.PAPER_SPEC, rows=16, cols=8,
                                 split_activation=True)
    spec_t = dataclasses.replace(tapps.PAPER_SPEC, rows=16, cols=8,
                                 split_activation=True)
    jl = _jax_layers([40, 12], 2)
    x = _x([40], 3) * 0.1
    ref = np.asarray(jxb.crossbar_apply(jl[0], x, spec_j, transport_in=False))
    tl = interop.layers_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jl], "cpu")
    got = txb.crossbar_apply(tl[0], torch.from_numpy(x), spec_t,
                             transport_in=False)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)
    np.testing.assert_allclose(
        _np(txb.crossbar_dp(tl[0], torch.from_numpy(x), spec_t)),
        np.asarray(jxb.crossbar_dp(jl[0], x, spec_j)), atol=ATOL)


def test_conductance_helpers_match_reference():
    w = np.random.default_rng(0).uniform(-1.5, 1.5, (7, 5)).astype(np.float32)
    spec_j, spec_t = japps.PAPER_SPEC, tapps.PAPER_SPEC
    for a, b in zip(txb.decompose(torch.from_numpy(w), spec_t),
                    jxb.decompose(w, spec_j)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(
        _np(txb.hard_sigmoid_deriv(torch.from_numpy(w * 4))),
        np.asarray(jxb.hard_sigmoid_deriv(w * 4)))
    np.testing.assert_array_equal(
        _np(txb.clip_conductance(torch.from_numpy(w), spec_t)),
        np.asarray(jxb.clip_conductance(w, spec_j)))
    assert spec_t.tiles(785, 300) == spec_j.tiles(785, 300) == (2, 3)
    g = txb.init_conductances(30, 20, spec_t,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    for v in g.values():
        assert v.shape == (30, 20) and float(v.min()) >= 0.0
        assert float(v.max()) < 0.02 * spec_t.w_max


def test_training_and_faults_are_not_ported_yet():
    # training is ported (tests/test_torch_chip_train.py) and so are faults
    # (tests/test_torch_faults.py): a faulted chip runs the eager path, a
    # null fault model leaves the chip as it was
    from repro_torch.runtime.faults import MemristorFaults
    _, tchip, _, x = _chips("kdd_anomaly")
    err = tchip.train_step(x, x, lr=0.1)
    assert tuple(err.shape) == x.shape
    faulted = VirtualChip(tchip.layers(), device="cpu",
                          faults=MemristorFaults(stuck_off=0.1))
    assert faulted.faults is not None and not faulted._compiled_active()
    null = VirtualChip(tchip.layers(), device="cpu",
                       faults=MemristorFaults())
    assert null.faults is None and null._compiled_active()


def test_placer_helpers_match_reference():
    from repro.sim import placer as jpl
    from repro_torch.sim import placer as tpl
    rng = np.random.default_rng(12)
    x = rng.uniform(-0.5, 0.5, (3, 20)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpl.tile_inputs(torch.from_numpy(x), 2, 3, 16)),
        np.asarray(jpl.tile_inputs(x, 2, 3, 16)))
    ys = rng.standard_normal((6, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpl.untile_outputs(torch.from_numpy(ys), 2, 3, 20)),
        np.asarray(jpl.untile_outputs(ys, 2, 3, 20)))
    np.testing.assert_array_equal(
        _np(tpl._agg_pattern(3, 8, torch.float32, torch.device("cpu"))),
        np.asarray(jpl._agg_pattern(3, 8, np.float32)))
