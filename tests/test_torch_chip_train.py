"""Port parity: ``repro_torch.sim.VirtualChip.train_step`` (on CPU, where
every stage's bwd and pulse phases run the kernels' plain versions)
against the reference chip's eager path (``REPRO_SIM_COMPILED=0``: its
``crossbar_bwd_stacked`` and ``pulse_update_stacked`` in interpret mode)
and against the port's own ``paper_backprop_step``, on the reference's
drawn conductances carried across with ``repro_torch.interop``.

Cases: kdd_anomaly (41-15-41), mnist_class at full width
(784-300-200-100-10, 13 cores) and the small 16x8 grid (20-10-5: several
tiles and a Fig.-14 aggregation stage).  Tolerances: step errors within
1e-6; conductances within 1e-6 except where the plain unrounded pulse
count 2 lr (a^T local) / (B u) lies within 1e-4 of a half-integer, where
one pulse may round the other way (the chip folds 1/B into lr, the rule
divides after the product, and the sums run in other orders) and a
conductance may differ by u/2 = 1.95e-4; counters and report fields
exactly equal, and ``compare_hw`` within 1 % on all six keys.
"""
import dataclasses
import json

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
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402

G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128

CASES = {
    "kdd_anomaly": dict(dims=[41, 15, 41], seed=0, n=2, grid={}),
    "mnist_class": dict(dims=[784, 300, 200, 100, 10], seed=0, n=2,
                        grid={}),
    "small_grid": dict(dims=[20, 10, 5], seed=3, n=3,
                       grid=dict(rows=16, cols=8)),
}


@pytest.fixture
def eager_reference(monkeypatch):
    """The reference chip's eager per-stage path (its Pallas kernels)."""
    monkeypatch.setenv("REPRO_SIM_COMPILED", "0")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, shape).astype(np.float32)


def _chips(name, spec_j=japps.PAPER_SPEC, spec_t=tapps.PAPER_SPEC):
    c = CASES[name]
    key = jax.random.PRNGKey(c["seed"])
    jl = [jxb.init_conductances(jax.random.fold_in(key, i), f, o, spec_j)
          for i, (f, o) in enumerate(zip(c["dims"], c["dims"][1:]))]
    np_layers = [{k: np.asarray(v) for k, v in p.items()} for p in jl]
    jchip = JaxChip(jl, spec_j, name=name, **c["grid"])
    tchip = VirtualChip(interop.layers_from_numpy(np_layers, "cpu"),
                        spec_t, name=name, device="cpu", **c["grid"])
    return jchip, tchip


def _batch(name, step=0):
    c = CASES[name]
    return (_uniform(20 + step, (c["n"], c["dims"][0])),
            _uniform(40 + step, (c["n"], c["dims"][-1])))


def plain_counts(layers, x, target, spec, lr):
    """The paper rule's unrounded pulse counts per layer (float64), from
    the port's plain math."""
    acts, dps, h = [], [], torch.from_numpy(x)
    for li, p in enumerate(layers):
        if li > 0 and spec.transport_quant:
            h = tq.adc_quantize(h, spec.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = torch.from_numpy(target) - h
    unit = spec.max_update / spec.update_levels
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        if spec.error_quant:
            delta = tq.error_quantize(delta, spec.err_bits).dequantize()
        local = delta * txb.hard_sigmoid_deriv(dps[li])
        acc = acts[li].double().T @ local.double()
        counts[li] = (2.0 * lr * acc / x.shape[0] / unit).numpy()
        delta = local @ (layers[li]["g_plus"] - layers[li]["g_minus"]).T
    return counts


def assert_layers_match(got, want, counts):
    """Conductances within G_ATOL, except one half pulse next to a
    half-integer of the plain ``counts`` (``None``: continuous update)."""
    for li, (a, b) in enumerate(zip(got, want)):
        near = np.zeros(np.shape(b["g_plus"]), bool)
        if counts is not None:
            c = counts[li]
            near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
        for k in ("g_plus", "g_minus"):
            d = np.abs(_np(a[k]) - _np(b[k]))
            assert np.all(d[~near] <= G_ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= HALF_U + G_ATOL), (li, k)


def _counters(c):
    return (c.samples, dict(c.slots), dict(c.core_steps), c.io_bits,
            c.noc.slot_cycles,
            [dataclasses.astuple(r) for r in c.noc.records])


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_reference_chip(name, eager_reference):
    jchip, tchip = _chips(name)
    x, tgt = _batch(name)
    before = tchip.layers()
    counts = plain_counts(before, x, tgt, tapps.PAPER_SPEC, 0.1)
    jerr = jchip.train_step(x, tgt, lr=0.1)
    terr = tchip.train_step(torch.from_numpy(x), torch.from_numpy(tgt),
                            lr=0.1)
    np.testing.assert_allclose(_np(terr), np.asarray(jerr), atol=G_ATOL)
    assert_layers_match(tchip.layers(), jchip.layers(), counts)
    assert _counters(tchip.train_counters) == \
        _counters(jchip.train_counters)
    assert dataclasses.asdict(tchip.report()) == \
        dataclasses.asdict(jchip.report())
    # the stage stacks were replaced, not the placement
    assert tchip.placement.version == len(tchip.placement.stages)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_paper_backprop_step(name):
    _, tchip = _chips(name)
    x, tgt = _batch(name, 1)
    before = tchip.layers()
    spec = dataclasses.replace(tapps.PAPER_SPEC, **CASES[name]["grid"])
    want, want_err = txb.paper_backprop_step(
        before, torch.from_numpy(x), torch.from_numpy(tgt), spec, lr=0.1)
    err = tchip.train_step(x, tgt, lr=0.1)
    np.testing.assert_allclose(_np(err), _np(want_err), atol=G_ATOL)
    assert_layers_match(tchip.layers(), want,
                        plain_counts(before, x, tgt, spec, 0.1))


def test_multi_step_training_stays_locked(eager_reference):
    """tests/test_chip_sim.py's three locked steps (x as its own target,
    lr 0.2, batch 4), held after every step against the reference chip
    and the port's paper rule."""
    c = CASES["kdd_anomaly"]
    key = jax.random.PRNGKey(5)
    jl = [jxb.init_conductances(jax.random.fold_in(key, i), f, o,
                                japps.PAPER_SPEC)
          for i, (f, o) in enumerate(zip(c["dims"], c["dims"][1:]))]
    np_layers = [{k: np.asarray(v) for k, v in p.items()} for p in jl]
    jchip = JaxChip(jl, japps.PAPER_SPEC)
    tchip = VirtualChip(interop.layers_from_numpy(np_layers, "cpu"),
                        tapps.PAPER_SPEC, device="cpu")
    ref = interop.layers_from_numpy(np_layers, "cpu")
    for step in range(3):
        x = np.array(jax.random.uniform(jax.random.PRNGKey(20 + step),
                                        (4, 41), minval=-0.5, maxval=0.5))
        counts = plain_counts(tchip.layers(), x, x, tapps.PAPER_SPEC, 0.2)
        jchip.train_step(x, x, lr=0.2)
        tchip.train_step(x, x, lr=0.2)
        ref, _ = txb.paper_backprop_step(ref, torch.from_numpy(x),
                                         torch.from_numpy(x),
                                         tapps.PAPER_SPEC, lr=0.2)
        assert_layers_match(tchip.layers(), jchip.layers(), counts)
        assert_layers_match(tchip.layers(), ref, counts)


@pytest.mark.parametrize("app", ["kdd_anomaly", "mnist_class"])
def test_sim_agrees_with_hw_model_within_1pct(app, eager_reference):
    """After one recognition wave and one train step the measured counters
    reproduce hw_model on all six keys (tests/test_chip_sim.py)."""
    dims = thw.PAPER_NETWORKS[app]
    jchip, tchip = _chips(app)
    x = _uniform(9, (1, dims[0]))
    tgt = _uniform(5, (1, dims[-1]))
    for chip in (jchip, tchip):
        chip.infer(x)
        chip.train_step(x, tgt, lr=0.1)
    errs = tchip.report().compare_hw(thw.network_cost(app, dims))
    assert set(errs) == {"infer_time", "infer_energy", "infer_io",
                         "train_time", "train_energy", "train_io"}
    assert all(v <= 0.01 for v in errs.values()), errs
    assert errs == jchip.report().compare_hw(jhw.network_cost(app, dims))


def test_continuous_update_matches_reference_chip(eager_reference):
    """update_quant=False takes the plain (non-pulsed) update path."""
    sj = dataclasses.replace(japps.PAPER_SPEC, update_quant=False)
    st = dataclasses.replace(tapps.PAPER_SPEC, update_quant=False)
    jchip, tchip = _chips("small_grid", sj, st)
    x, tgt = _batch("small_grid", 2)
    before = tops.pulse_update_stacked.launches
    jerr = jchip.train_step(x, tgt, lr=0.3)
    terr = tchip.train_step(x, tgt, lr=0.3)
    np.testing.assert_allclose(_np(terr), np.asarray(jerr), atol=G_ATOL)
    assert_layers_match(tchip.layers(), jchip.layers(), None)
    assert tops.pulse_update_stacked.launches == before


def test_backward_update_returns_the_input_error(eager_reference):
    """backward_update over the whole chip hands back the error at the
    network input (what would cross a link to an upstream chip)."""
    jchip, tchip = _chips("small_grid")
    x, tgt = _batch("small_grid", 3)
    jacts, jdps, jout = jchip.forward_wave(x, train=True)
    tacts, tdps, tout = tchip.forward_wave(x, train=True)
    jd = jchip.backward_update(jacts, jdps, tgt - jout, 0.1)
    td = tchip.backward_update(tacts, tdps, torch.from_numpy(tgt) - tout,
                               0.1)
    assert tuple(td.shape) == (3, 20)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=1e-5)
    assert _counters(tchip.train_counters) == \
        _counters(jchip.train_counters)


def test_cpu_training_counts_no_launch():
    _, tchip = _chips("kdd_anomaly")
    names = ("crossbar_fwd_stacked", "crossbar_bwd_stacked",
             "pulse_update_stacked")
    before = [getattr(tops, n).launches for n in names]
    tchip.train_step(*_batch("kdd_anomaly"), lr=0.1)
    assert [getattr(tops, n).launches for n in names] == before


def test_cli_trains_on_cpu(tmp_path, capsys):
    from repro_torch.launch import chipsim
    out = tmp_path / "train.json"
    chipsim.main(["--app", "kdd_anomaly", "--device", "cpu",
                  "--train-steps", "2", "--batch", "3", "--samples", "4",
                  "--json", str(out)])
    text = capsys.readouterr().out
    assert "train step 0" in text and "train step 1" in text
    assert "train_time=" in text and "train_io=" in text
    record = json.loads(out.read_text())
    assert set(record["cross_validation"]) >= {"train_time", "train_energy",
                                               "train_io"}
    assert all(v <= 0.01 for v in record["cross_validation"].values())
