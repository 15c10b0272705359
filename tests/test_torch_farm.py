"""Port parity: the chip farm (``repro_torch.sim.cluster`` and
``repro_torch.dist.collectives``) against the reference's
(``repro.sim.cluster``, ``repro.dist.collectives``), the statements of
``tests/test_farm.py`` held port against reference and port against port.

The reference farm runs its default compiled path; the port farm its
default too (on the CPU, the stage loop with the kernels' plain versions),
on the reference's conductances carried across with
``repro_torch.interop``.  Tolerances: fp32 values within 1e-6 (served
outputs within 1e-5, the reference test's bar); conductances within 1e-6
except where the plain unrounded pulse count lies within 1e-4 of a
half-integer, where one pulse may round the other way (u/2 = 1.95e-4) —
the farm sums its C per-chip outer products in chip order, the serial
chip one chain over the batch; replicas bit for bit in lockstep; counters,
serving stats, reports and ``farm_cost`` exactly equal.  The reference's
meshed tests (``make_farm_mesh``, ``ChipFarm(mesh=)``) wait for a
multi-GPU host.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb, hw_model as jhw  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.runtime.serve_loop import RequestQueue as JaxQueue  # noqa: E402
from repro.sim import ChipFarm as JaxFarm  # noqa: E402
from repro.sim.cluster import FarmServer as JaxServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb, hw_model as thw  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.dist.collectives import farm_max, farm_reduce_sum  # noqa: E402
from repro_torch.runtime.serve_loop import RequestQueue  # noqa: E402
from repro_torch.sim import ChipFarm, VirtualChip  # noqa: E402
from repro_torch.sim.cluster import FarmServer, build_farm  # noqa: E402

G_ATOL = 1e-6
SERVE_ATOL = 1e-5
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128
SPEC = tapps.PAPER_SPEC
MNIST = [784, 300, 200, 100, 10]


@pytest.fixture(autouse=True)
def compiled_reference(monkeypatch):
    """The reference farm's default path: its compiled executor."""
    monkeypatch.delenv("REPRO_SIM_COMPILED", raising=False)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _layers(dims, seed=0):
    """(reference layers, the same as numpy) from the reference's draw."""
    key = jax.random.PRNGKey(seed)
    jl = [jxb.init_conductances(jax.random.fold_in(key, i), f, o,
                                japps.PAPER_SPEC)
          for i, (f, o) in enumerate(zip(dims, dims[1:]))]
    return jl, [{k: np.asarray(v) for k, v in p.items()} for p in jl]


def _x(dims, n=4, seed=9):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (n, dims[0]), minval=-0.5,
                                       maxval=0.5))


def _t(n, width, seed):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (n, width), minval=-0.5,
                                       maxval=0.5))


def _farm(np_layers, n_chips=2, **kw):
    return ChipFarm(interop.layers_from_numpy(np_layers, "cpu"), SPEC,
                    n_chips=n_chips, device="cpu", **kw)


def _chip(np_layers, **kw):
    return VirtualChip(interop.layers_from_numpy(np_layers, "cpu"), SPEC,
                       device="cpu", **kw)


def plain_counts(layers, x, target, lr):
    """The paper rule's unrounded pulse counts per layer (float64)."""
    acts, dps, h = [], [], torch.from_numpy(x)
    for li, p in enumerate(layers):
        if li > 0:
            h = tq.adc_quantize(h, SPEC.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = torch.from_numpy(target) - h
    unit = SPEC.max_update / SPEC.update_levels
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        delta = tq.error_quantize(delta, SPEC.err_bits).dequantize()
        local = delta * txb.hard_sigmoid_deriv(dps[li])
        acc = acts[li].double().T @ local.double()
        counts[li] = (2.0 * lr * acc / x.shape[0] / unit).numpy()
        delta = local @ (layers[li]["g_plus"] - layers[li]["g_minus"]).T
    return counts


def assert_layers_match(got, want, counts):
    for li, (a, b) in enumerate(zip(got, want)):
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


# ---------------------------------------------------------------------------
# Farm == serial chip, and the port farm == the reference farm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,n_chips", [([41, 15, 41], 2), (MNIST, 2)])
def test_farm_train_matches_serial_chip(dims, n_chips):
    """A 2-chip data-parallel farm on a fixed batch matches the serial
    chip's step on the same data, port against port and against the
    reference farm; its counters equal the reference farm's."""
    jl, np_layers = _layers(dims)
    farm = _farm(np_layers, n_chips)
    chip = _chip(np_layers)
    jfarm = JaxFarm(jl, japps.PAPER_SPEC, n_chips=n_chips)
    x, tgt = _x(dims, n=4), _t(4, dims[-1], 4)
    counts = plain_counts(chip.layers(), x, tgt, 0.1)
    ef = farm.train_step(x, tgt, lr=0.1)
    ec = chip.train_step(x, tgt, lr=0.1)
    ej = jfarm.train_step(x, tgt, lr=0.1)
    np.testing.assert_allclose(_np(ef), _np(ec), atol=G_ATOL)
    np.testing.assert_allclose(_np(ef), np.asarray(ej), atol=G_ATOL)
    assert_layers_match(farm.layers(), chip.layers(), counts)
    assert_layers_match(farm.layers(), jfarm.layers(), counts)
    assert farm.replicas_in_sync()
    for a, b in zip(farm.chip_train, jfarm.chip_train):
        assert _counters(a) == _counters(b)
    assert dataclasses.astuple(farm.train_link) == \
        dataclasses.astuple(jfarm.train_link)


def test_farm_multi_step_stays_locked_and_in_sync():
    dims = [41, 15, 41]
    jl, np_layers = _layers(dims, seed=5)
    farm = _farm(np_layers)
    chip = _chip(np_layers)
    jfarm = JaxFarm(jl, japps.PAPER_SPEC, n_chips=2)
    for step in range(3):
        x = _x(dims, n=4, seed=20 + step)
        counts = plain_counts(chip.layers(), x, x, 0.2)
        farm.train_step(x, x, lr=0.2)
        chip.train_step(x, x, lr=0.2)
        jfarm.train_step(x, x, lr=0.2)
        assert farm.replicas_in_sync()
        assert_layers_match(farm.layers(), chip.layers(), counts)
        assert_layers_match(farm.layers(), jfarm.layers(), counts)
    # lockstep is bitwise, in every stage of every replica
    for gp in farm._gp:
        assert all(torch.equal(gp[0], gp[c]) for c in range(1, 2))


def test_farm_infer_matches_chip():
    dims = [41, 15, 41]
    jl, np_layers = _layers(dims)
    farm = _farm(np_layers)
    x = _x(dims, n=6)
    out = farm.infer(x)
    np.testing.assert_allclose(_np(out), _np(_chip(np_layers).infer(x)),
                               atol=G_ATOL)
    jfarm = JaxFarm(jl, japps.PAPER_SPEC, n_chips=2)
    np.testing.assert_allclose(_np(out), np.asarray(jfarm.infer(x)),
                               atol=G_ATOL)
    for a, b in zip(farm.chip_infer, jfarm.chip_infer):
        assert _counters(a) == _counters(b)


def test_int8_reconcile_keeps_replicas_in_sync():
    """Compressed reconciliation changes the update (bounded error) but
    every replica still applies the SAME pulses — no silent drift."""
    dims = [41, 15, 41]
    _, np_layers = _layers(dims)
    x = _x(dims)
    exact, coded = _farm(np_layers), _farm(np_layers)
    exact.train_step(x, x, lr=0.3)
    coded.train_step(x, x, lr=0.3, reconcile="int8")
    assert coded.replicas_in_sync()
    moved = [float((a["g_plus"] - b["g_plus"]).abs().max())
             for a, b in zip(coded.layers(), exact.layers())]
    assert max(moved) <= 2 * HALF_U + G_ATOL      # at most one pulse apart


def test_batch_must_divide_over_chips():
    farm = _farm(_layers([41, 15, 41])[1])
    with pytest.raises(ValueError, match="divide"):
        farm.train_step(_x([41, 15, 41], n=3), _x([41, 15, 41], n=3),
                        lr=0.1)


# ---------------------------------------------------------------------------
# Serving front-end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [[41, 15, 41], MNIST])
def test_served_outputs_equal_mlp_forward(dims):
    jl, np_layers = _layers(dims)
    farm = _farm(np_layers)
    x = _x(dims, n=6)
    out, stats = farm.serve(x)
    ref = txb.mlp_forward(interop.layers_from_numpy(np_layers, "cpu"), x,
                          SPEC, device="cpu")
    np.testing.assert_allclose(_np(out), _np(ref), atol=SERVE_ATOL)
    assert stats["retired"] == 6
    assert stats["beat_us"] == pytest.approx(0.77)
    jout, jstats = JaxFarm(jl, japps.PAPER_SPEC, n_chips=2).serve(x)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=SERVE_ATOL)
    assert stats == jstats


def test_serving_preserves_request_order_across_chips():
    """Round-robin routing over chips must not reorder the client-visible
    result stream."""
    dims = [41, 15, 41]
    _, np_layers = _layers(dims)
    farm = _farm(np_layers, n_chips=3)
    x = _x(dims, n=7)          # not divisible by 3: last beat partially idle
    out, _ = farm.serve(x)
    np.testing.assert_allclose(_np(out), _np(_chip(np_layers).infer(x)),
                               atol=G_ATOL)


def test_serve_beats_and_throughput_scaling():
    """Q requests over C chips retire in S-1 + Q/C beats; steady-state
    throughput is C samples per beat — monotone in the chip count."""
    dims = [41, 15, 41]
    _, np_layers = _layers(dims)
    x = _x(dims, n=8)
    S = len(dims) - 1
    sps = []
    for chips in (1, 2, 4):
        farm = _farm(np_layers, n_chips=chips)
        _, stats = farm.serve(x)
        assert stats["beats"] == S - 1 + 8 // chips
        sps.append(stats["samples_per_s"])
        assert stats["samples_per_s"] == pytest.approx(
            chips * 1e6 / farm.beat_us)
    assert sps[0] < sps[1] < sps[2]


def test_farm_server_rejects_stale_conductance_snapshot():
    """A FarmServer built before a train_step holds stale stacks; using
    it must fail loudly rather than serve outdated weights."""
    dims = [41, 15, 41]
    farm = _farm(_layers(dims)[1])
    server = FarmServer(farm)
    x = _x(dims, n=2)
    farm.train_step(x, x, lr=0.1)
    with pytest.raises(RuntimeError, match="fresh server"):
        server.run(RequestQueue(list(torch.from_numpy(x))))
    out, _ = farm.serve(x)      # a fresh server sees the new weights
    np.testing.assert_allclose(
        _np(out), _np(txb.mlp_forward(farm.layers(), x, SPEC,
                                      device="cpu")), atol=SERVE_ATOL)


def test_serve_empty_queue_and_shared_placement_validation():
    farm = build_farm("kdd_anomaly", 2, seed=0, share_small_layers=True,
                      device="cpu")
    out, stats = farm.serve(torch.zeros((0, 41)))
    assert tuple(out.shape) == (0, 41) and stats["retired"] == 0
    # a shared-placement farm cross-validates against farm_cost built
    # with the SAME share_small_layers setting (report carries it)
    x = _x([41, 15, 41], n=4, seed=3)
    farm.serve(x)
    farm.train_step(x, x, lr=0.1)
    errs = {**farm.report().compare_chip_sum(), **farm.report().compare_hw()}
    assert all(v <= 0.01 for v in errs.values()), errs


def test_farm_server_rejects_ragged_request_batches():
    """The per-beat slab needs one static microbatch shape; a mixed-shape
    queue must fail loudly, not mis-assemble."""
    farm = _farm(_layers([41, 15, 41])[1], n_chips=1)
    server = FarmServer(farm)
    queue = RequestQueue()
    queue.submit(torch.zeros((1, 41)))
    queue.submit(torch.zeros((3, 41)))
    with pytest.raises(ValueError, match="microbatch"):
        server.run(queue)


def test_farm_server_uniform_microbatches_supported():
    """Uniform (m, D) requests serve m samples per slot per beat."""
    dims = [41, 15, 41]
    _, np_layers = _layers(dims)
    farm = _farm(np_layers)
    server = FarmServer(farm)
    reqs = [_x(dims, n=3, seed=s) for s in (1, 2, 3, 4)]
    queue = RequestQueue(reqs)
    stats = server.run(queue)
    assert stats["retired"] == 12           # 4 requests x 3 samples
    layers = interop.layers_from_numpy(np_layers, "cpu")
    for got, x in zip(queue.results(), reqs):
        np.testing.assert_allclose(
            _np(got), _np(txb.mlp_forward(layers, x, SPEC, device="cpu")),
            atol=SERVE_ATOL)


def test_farm_server_per_slot_refill():
    """The queue refills each chip's stage-0 slot per beat; a queue larger
    than the farm drains completely and completes every request once —
    eager, one beat at a time, and compiled, alike."""
    dims = [41, 15, 41]
    for compiled in (False, True):
        farm = _farm(_layers(dims)[1], compiled=compiled)
        server = FarmServer(farm)
        queue = RequestQueue(list(torch.from_numpy(_x(dims, n=5))))
        stats = server.run(queue)
        assert queue.drained and queue.completed == 5
        assert stats["retired"] == 5
        with pytest.raises(ValueError):
            queue.complete(0, None)    # double-completion is an error


def test_served_stats_and_counters_equal_the_reference():
    """Both farms' default serving sessions on the same queue: outputs
    within 1e-5, and the stats, per-chip counters and host-link meter
    exactly equal."""
    jl, np_layers = _layers(MNIST)
    x = _x(MNIST, n=7, seed=2)
    farm = _farm(np_layers, n_chips=3)
    jfarm = JaxFarm(jl, japps.PAPER_SPEC, n_chips=3)
    out, stats = farm.serve(x)
    jout, jstats = jfarm.serve(x)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=SERVE_ATOL)
    assert stats == jstats
    for a, b in zip(farm.chip_infer, jfarm.chip_infer):
        assert _counters(a) == _counters(b)
    assert dataclasses.astuple(farm.serve_link) == \
        dataclasses.astuple(jfarm.serve_link)
    assert (farm.serve_beats, farm.serve_full_beats, farm.serve_sessions) \
        == (jfarm.serve_beats, jfarm.serve_full_beats, jfarm.serve_sessions)
    # the reference's eager server, step by step, on the same snapshot
    server, jserver = FarmServer(farm), JaxServer(jfarm)
    q, jq = RequestQueue(list(torch.from_numpy(x))), JaxQueue(list(x))
    assert server.run(q, max_beats=3) == jserver.run(jq, max_beats=3)
    assert q.completed == jq.completed


# ---------------------------------------------------------------------------
# Farm accounting: measured counters vs chip sums vs analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app,chips", [("kdd_anomaly", 2),
                                       ("mnist_class", 2)])
def test_farm_cross_validation_within_1pct(app, chips):
    dims = thw.PAPER_NETWORKS[app]
    jl, np_layers = _layers(dims)
    farm = ChipFarm(interop.layers_from_numpy(np_layers, "cpu"), SPEC,
                    n_chips=chips, name=app, device="cpu")
    jfarm = JaxFarm(jl, japps.PAPER_SPEC, n_chips=chips, name=app)
    x = _x(dims, n=2 * chips, seed=1)
    tgt = _t(2 * chips, dims[-1], 5)
    for f in (farm, jfarm):
        f.serve(x)
        f.train_step(x, tgt, lr=0.1)
    rep = farm.report()
    errs = {**rep.compare_chip_sum(), **rep.compare_hw()}
    assert {"serve_energy_vs_chips", "train_energy_vs_chips",
            "infer_lockstep", "train_lockstep", "serve_energy",
            "train_energy", "beat", "serve_throughput",
            "host_serve_bits", "train_step_time",
            "reconcile_bits"} <= set(errs)
    for k, v in errs.items():
        assert v <= 0.01, (app, k, v)
    jrep = jfarm.report()
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert errs == {**jrep.compare_chip_sum(), **jrep.compare_hw()}
    assert dataclasses.asdict(thw.farm_cost(app, dims, chips)) == \
        dataclasses.asdict(jhw.farm_cost(app, dims, chips))


def test_ragged_request_count_still_cross_validates():
    """7 requests on 2 chips leave the final beat half idle; capacity is
    measured over full beats only, so the 1% gate still holds."""
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    farm.serve(_x([41, 15, 41], n=7, seed=4))
    rep = farm.report()
    errs = {**rep.compare_chip_sum(), **rep.compare_hw()}
    assert "serve_throughput" in errs
    assert all(v <= 0.01 for v in errs.values()), errs
    assert rep.serve_samples_per_s == pytest.approx(2e6 / farm.beat_us)


def test_custom_grid_farm_cross_validates():
    """farm_cost honors a non-default core grid end to end (mapping,
    beat, phase costs), so small-grid farms meet the same contract."""
    dims = [20, 10, 5]
    _, np_layers = _layers(dims, seed=3)
    farm = _farm(np_layers, rows=16, cols=8, name="small_grid")
    x = _x(dims, n=4, seed=5)
    farm.serve(x)
    farm.train_step(x, _t(4, 5, 6), lr=0.1)
    errs = {**farm.report().compare_chip_sum(),
            **farm.report().compare_hw()}
    assert all(v <= 0.01 for v in errs.values()), errs


def test_farm_report_aggregates_per_chip_counters():
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    farm.serve(_x([41, 15, 41], n=4, seed=2))
    rep = farm.report()
    assert rep.n_chips == 2 and len(rep.per_chip) == 2
    assert sum(r.infer_samples for r in rep.per_chip) == 4
    assert rep.cores == 2 * farm.placement.n_cores
    # farm energy = per-chip energy + host link, never less than chips alone
    chip_j = sum(r.infer_total_j * r.infer_samples
                 for r in rep.per_chip) / 4
    assert rep.serve_j_per_sample > chip_j


def test_reconcile_traffic_measured_from_stack_sizes():
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    x = _x([41, 15, 41], n=2)
    farm.train_step(x, x, lr=0.1)
    rep = farm.report()
    cells = sum(st.g_plus.numel() for st in farm.placement.stages)
    assert rep.host_reconcile_bits == 2 * 2 * cells * thw.ERR_BITS_LINK


def test_farm_cost_flags_link_bound_configs():
    wide = [4000, 100, 10]
    fc = thw.farm_cost("wide", wide, 2)
    assert fc.serve_samples_per_s == pytest.approx(2e6 / fc.beat_us)
    assert fc.host_link_utilization > 1.0
    assert thw.farm_cost("kdd_anomaly", [41, 15, 41], 2) \
        .host_link_utilization < 1.0


# ---------------------------------------------------------------------------
# Reconciliation collectives
# ---------------------------------------------------------------------------

def test_farm_reduce_sum_modes():
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (3, 4, 5)))
    tx = torch.from_numpy(x)
    exact = farm_reduce_sum(tx, mode="none")
    np.testing.assert_array_equal(_np(exact), _np(tx[0] + tx[1] + tx[2]))
    np.testing.assert_allclose(
        _np(exact), np.asarray(jcoll.farm_reduce_sum(x, mode="none")),
        atol=1e-6)
    coded = farm_reduce_sum(tx, mode="int8")
    # each chip's codes are the reference's: the sums agree to rounding
    np.testing.assert_allclose(
        _np(coded), np.asarray(jcoll.farm_reduce_sum(x, mode="int8")),
        atol=1e-6)
    # bounded code error: per-element within half a step of the full-scale
    scale = float(np.abs(x).max()) / 127
    assert float((coded - tx.sum(0)).abs().max()) <= 3 * 0.5 * scale + 1e-6
    with pytest.raises(ValueError):
        farm_reduce_sum(tx, mode="fp4")


def test_int8_reconcile_scales_per_chip():
    """Each chip's contribution is coded against its OWN full-scale: a
    quiet chip's update must survive next to a loud chip's."""
    loud = torch.full((1, 4), 100.0)
    quiet = torch.full((1, 4), 1e-3)
    out = farm_reduce_sum(torch.stack([loud, quiet]), mode="int8")
    np.testing.assert_allclose(_np(out - loud), _np(quiet), atol=1e-4)


def test_farm_max_is_global_max():
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(farm_max(x), x.max(0, keepdim=True).values)
    np.testing.assert_array_equal(
        _np(farm_max(x)), np.asarray(jcoll.farm_max(jnp.asarray(_np(x)))))
