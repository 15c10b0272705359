"""Port parity: the pipeline fabric (``repro_torch.sim.fabric`` and
``repro_torch.launch.pipeline``) against the reference's
(``repro.sim.fabric``), the statements of ``tests/test_pipeline_fabric.py``
held port against reference and port against port.  The stage-split and
1F1B schedule tests of that file are held in
``tests/test_torch_mapping_hw.py``.

The reference runs its default compiled path; the port its default too
(on the CPU, the stage loop with the kernels' plain versions), on the
reference's conductances and inputs carried across as numpy arrays.
Tolerances: against the reference, fp32 values within 1e-5 and
conductances within 1e-6 except where the plain unrounded pulse count lies
within 1e-4 of a half-integer, where one pulse may round the other way
(u/2 = 1.95e-4); counters, link bits, serving stats and reports exactly
equal.  Port against port, the pipeline equals the unsplit chip bit for
bit (errors, conductances, waves), the farm of pipelines is bit for bit
in lockstep and within 1e-6 of the serial chip (the farm's own bar).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb  # noqa: E402
from repro.runtime.serve_loop import RequestQueue as JaxQueue  # noqa: E402
from repro.sim import ChipPipeline as JaxPipe  # noqa: E402
from repro.sim import PipelineFarm as JaxPipeFarm  # noqa: E402
from repro.sim.fabric import PipelineServer as JaxServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb, hw_model as thw  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.core.mapping import map_network  # noqa: E402
from repro_torch.runtime.serve_loop import RequestQueue  # noqa: E402
from repro_torch.sim import (ChipPipeline, PipelineFarm,  # noqa: E402
                             VirtualChip)
from repro_torch.sim.fabric import PipelineServer, build_pipeline  # noqa: E402

ATOL = 1e-5
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128
SPEC = tapps.PAPER_SPEC
MNIST = [784, 300, 200, 100, 10]
ISOLET = [617, 2000, 1000, 500, 250, 26]
KDD = [41, 15, 41]


@pytest.fixture(autouse=True)
def compiled_reference(monkeypatch):
    """The reference fabric's default path: its compiled executor."""
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


def _pipe(np_layers, **kw):
    return ChipPipeline(interop.layers_from_numpy(np_layers, "cpu"), SPEC,
                        device="cpu", **kw)


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
    """Conductances within 1e-6, one pulse excused near k + 1/2."""
    for li, (a, b) in enumerate(zip(got, want)):
        c = counts[li]
        near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
        for k in ("g_plus", "g_minus"):
            d = np.abs(_np(a[k]) - _np(b[k]))
            assert np.all(d[~near] <= G_ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= HALF_U + G_ATOL), (li, k)


def assert_layers_equal(got, want):
    for a, b in zip(got, want):
        for k in ("g_plus", "g_minus"):
            assert torch.equal(a[k], b[k]), k


def _counters(c):
    return (c.samples, dict(c.slots), dict(c.core_steps), c.io_bits,
            c.noc.slot_cycles,
            [dataclasses.astuple(r) for r in c.noc.records])


def assert_accounting_equal(pipe, jpipe):
    """Per-slice counters and the inter-chip link: exactly the
    reference's."""
    assert pipe.groups == jpipe.groups
    assert pipe.boundary_dims == jpipe.boundary_dims
    for a, b in zip(pipe.chips, jpipe.chips):
        assert _counters(a.train_counters) == _counters(b.train_counters)
        assert _counters(a.infer_counters) == _counters(b.infer_counters)
    assert dataclasses.astuple(pipe.link) == dataclasses.astuple(jpipe.link)


# ---------------------------------------------------------------------------
# The pipeline equals the serial chip (port against port, bit for bit),
# and the reference's pipeline (within the tolerances above)
# ---------------------------------------------------------------------------

def test_single_chip_degenerate_split_is_bitwise_serial():
    """Under the default 144-core budget a small network stays on one
    chip, and the fabric IS the serial chip — bitwise, zero link bits."""
    jl, np_layers = _layers(KDD)
    pipe, chip = _pipe(np_layers), _chip(np_layers)
    jpipe = JaxPipe(jl, japps.PAPER_SPEC)
    assert pipe.n_chips == 1 and pipe.boundary_dims == ()
    x = _x(KDD)
    out = pipe.infer(x)
    assert torch.equal(out, chip.infer(x))
    np.testing.assert_allclose(_np(out), np.asarray(jpipe.infer(x)),
                               atol=ATOL)
    counts = plain_counts(pipe.layers(), x, x, 0.2)
    ef = pipe.train_step(x, x, lr=0.2)
    assert torch.equal(ef, chip.train_step(x, x, lr=0.2))
    assert_layers_equal(pipe.layers(), chip.layers())
    np.testing.assert_allclose(_np(ef), np.asarray(
        jpipe.train_step(x, x, lr=0.2)), atol=ATOL)
    assert_layers_match(pipe.layers(), jpipe.layers(), counts)
    assert pipe.link.fwd_bits_total == pipe.link.bwd_bits_total == 0
    assert_accounting_equal(pipe, jpipe)


@pytest.mark.parametrize("split_kw", [dict(n_chips=2),
                                      dict(max_cores_per_chip=9)])
def test_pipeline_train_is_bitwise_serial(split_kw):
    """A network split over >= 2 chips (mnist_class: 13 cores, both split
    modes) trains bit for bit like the serial unsplit chip, and within
    the tolerances of the reference's pipeline."""
    jl, np_layers = _layers(MNIST)
    pipe, chip = _pipe(np_layers, **split_kw), _chip(np_layers)
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, **split_kw)
    assert pipe.n_chips >= 2
    x, tgt = _x(MNIST, n=4), _t(4, MNIST[-1], 4)
    counts = plain_counts(pipe.layers(), x, tgt, 0.1)
    ef = pipe.train_step(x, tgt, lr=0.1)
    assert torch.equal(ef, chip.train_step(x, tgt, lr=0.1))
    assert_layers_equal(pipe.layers(), chip.layers())
    np.testing.assert_allclose(_np(ef), np.asarray(
        jpipe.train_step(x, tgt, lr=0.1)), atol=ATOL)
    assert_layers_match(pipe.layers(), jpipe.layers(), counts)
    assert_accounting_equal(pipe, jpipe)


def test_ragged_stage_split_multi_step_stays_locked():
    """An uneven 3-way split (1/1/2 stages on mnist) stays bit for bit
    locked to the serial chip over multiple steps, microbatched or not.
    (The reference's own pipeline fails this statement against its
    serial chip; the port is held to the statement, and to the
    reference's pipeline within the tolerances.)"""
    jl, np_layers = _layers(MNIST, seed=5)
    pipe, chip = _pipe(np_layers, n_chips=3), _chip(np_layers)
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, n_chips=3)
    assert sorted(len(g) for g in pipe.groups) == [1, 1, 2]
    for step in range(2):
        x = _x(MNIST, n=4, seed=20 + step)
        t = x[:, :MNIST[-1]]
        counts = plain_counts(pipe.layers(), x, t, 0.2)
        n_micro = 2 if step else 1
        ef = pipe.train_step(x, t, lr=0.2, n_micro=n_micro)
        assert torch.equal(ef, chip.train_step(x, t, lr=0.2))
        assert_layers_equal(pipe.layers(), chip.layers())
        ej = jpipe.train_step(x, t, lr=0.2, n_micro=n_micro)
        np.testing.assert_allclose(_np(ef), np.asarray(ej), atol=ATOL)
        assert_layers_match(pipe.layers(), jpipe.layers(), counts)
    assert pipe.n_micro == 2
    assert_accounting_equal(pipe, jpipe)


def test_pipeline_infer_matches_serial_chip():
    jl, np_layers = _layers(MNIST)
    pipe = _pipe(np_layers, n_chips=2)
    x = _x(MNIST, n=3)
    out = pipe.infer(x)
    assert torch.equal(out, _chip(np_layers).infer(x))
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, n_chips=2)
    np.testing.assert_allclose(_np(out), np.asarray(jpipe.infer(x)),
                               atol=ATOL)
    assert_accounting_equal(pipe, jpipe)


def test_network_exceeding_paper_chip_budget_runs_across_two_chips():
    """isolet_class places 160 cores — more than the paper's 144-core
    chip — so under the default budget it splits across 2 chips (130 +
    30 cores), trains bit for bit like the serial chip, serves, and its
    counters cross-validate against pipeline_cost within 1 %."""
    jl, np_layers = _layers(ISOLET)
    assert map_network(ISOLET).cores > thw.SYSTEM_CORES
    pipe, chip = _pipe(np_layers, name="isolet_class"), _chip(np_layers)
    assert pipe.groups == ((0, 1), (2, 3, 4))
    assert [c.placement.n_cores for c in pipe.chips] == [130, 30]
    x, tgt = _x(ISOLET, n=2), _t(2, ISOLET[-1], 4)
    ef = pipe.train_step(x, tgt, lr=0.1)
    assert torch.equal(ef, chip.train_step(x, tgt, lr=0.1))
    assert_layers_equal(pipe.layers(), chip.layers())
    out, stats = pipe.serve(x)
    ref = txb.mlp_forward(pipe.layers(), x, SPEC, device="cpu")
    np.testing.assert_allclose(_np(out), _np(ref), atol=G_ATOL)
    errs = pipe.report().compare_hw()
    assert all(v <= 0.01 for v in errs.values()), errs
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, name="isolet_class")
    np.testing.assert_allclose(_np(ef), np.asarray(
        jpipe.train_step(x, tgt, lr=0.1)), atol=ATOL)
    jout, jstats = jpipe.serve(x)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATOL)
    assert stats == jstats
    assert errs == jpipe.report().compare_hw()


# ---------------------------------------------------------------------------
# Serving front-end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compiled", [True, False])
def test_served_outputs_equal_mlp_forward_and_preserve_order(compiled,
                                                             monkeypatch):
    """Compiled, one captured beat per beat; eager, the per-beat loop
    (against the reference's eager server, whose NoC records are per
    beat too)."""
    if not compiled:
        monkeypatch.setenv("REPRO_SIM_COMPILED", "0")
    jl, np_layers = _layers(MNIST)
    pipe = _pipe(np_layers, n_chips=2, compiled=compiled)
    x = _x(MNIST, n=5)
    out, stats = pipe.serve(x)
    ref = txb.mlp_forward(interop.layers_from_numpy(np_layers, "cpu"), x,
                          SPEC, device="cpu")
    np.testing.assert_allclose(_np(out), _np(ref), atol=G_ATOL)
    S = len(MNIST) - 1
    assert stats["beats"] == S - 1 + 5          # one beat per stage hop
    assert stats["beat_us"] == pytest.approx(0.77)
    assert stats["latency_us"] == pytest.approx(S * 0.77)
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, n_chips=2)
    jout, jstats = jpipe.serve(x)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=ATOL)
    assert stats == jstats
    assert_accounting_equal(pipe, jpipe)
    assert (pipe.serve_beats, pipe.serve_samples, pipe.serve_full_beats,
            pipe.serve_slot_m) == (jpipe.serve_beats, jpipe.serve_samples,
                                   jpipe.serve_full_beats,
                                   jpipe.serve_slot_m)


def test_pipeline_server_rejects_stale_conductance_snapshot():
    _, np_layers = _layers(KDD)
    pipe = _pipe(np_layers, n_chips=2)
    server = PipelineServer(pipe)
    x = _x(KDD, n=2)
    pipe.train_step(x, x, lr=0.1)
    with pytest.raises(RuntimeError, match="fresh server"):
        server.run(RequestQueue(list(torch.from_numpy(x))))
    with pytest.raises(RuntimeError, match="fresh server"):
        server.step(RequestQueue(list(torch.from_numpy(x))))
    out, _ = pipe.serve(x)          # a fresh server sees the new weights
    np.testing.assert_allclose(
        _np(out), _np(txb.mlp_forward(pipe.layers(), x, SPEC,
                                      device="cpu")), atol=ATOL)


def test_pipeline_server_rejects_ragged_request_batches():
    jl, np_layers = _layers(KDD)
    for server in (PipelineServer(_pipe(np_layers, n_chips=2)),
                   PipelineServer(_pipe(np_layers, n_chips=2,
                                        compiled=False))):
        queue = RequestQueue()
        queue.submit(torch.zeros((1, 41)))
        queue.submit(torch.zeros((3, 41)))
        with pytest.raises(ValueError, match="microbatch"):
            server.run(queue)
    jqueue = JaxQueue()
    jqueue.submit(np.zeros((1, 41), np.float32))
    jqueue.submit(np.zeros((3, 41), np.float32))
    with pytest.raises(ValueError, match="microbatch"):
        JaxServer(JaxPipe(jl, japps.PAPER_SPEC, n_chips=2)).run(jqueue)


def test_pipeline_serve_empty_queue():
    jl, np_layers = _layers(KDD)
    out, stats = _pipe(np_layers, n_chips=2).serve(torch.zeros((0, 41)))
    assert tuple(out.shape) == (0, 41) and stats["retired"] == 0
    _, jstats = JaxPipe(jl, japps.PAPER_SPEC, n_chips=2).serve(
        np.zeros((0, 41), np.float32))
    assert stats == jstats


def test_pipeline_serve_uniform_microbatches():
    jl, np_layers = _layers(KDD)
    pipe = _pipe(np_layers, n_chips=2)
    reqs = [_x(KDD, n=3, seed=s) for s in (1, 2, 3)]
    queue = RequestQueue(reqs)
    stats = PipelineServer(pipe).run(queue)
    assert stats["retired"] == 9
    layers = interop.layers_from_numpy(np_layers, "cpu")
    jqueue = JaxQueue(reqs)
    jstats = JaxServer(JaxPipe(jl, japps.PAPER_SPEC, n_chips=2)).run(jqueue)
    assert stats == jstats
    for got, jgot, x in zip(queue.results(), jqueue.results(), reqs):
        np.testing.assert_allclose(
            _np(got), _np(txb.mlp_forward(layers, x, SPEC, device="cpu")),
            atol=ATOL)
        np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=ATOL)


# ---------------------------------------------------------------------------
# Accounting: measured counters vs hw_model.pipeline_cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,name,kw", [
    (MNIST, "mnist_class", dict(n_chips=2)),
    (MNIST, "mnist_class", dict(max_cores_per_chip=9)),
])
def test_pipeline_cross_validation_within_1pct(dims, name, kw):
    jl, np_layers = _layers(dims)
    pipe = _pipe(np_layers, name=name, **kw)
    jpipe = JaxPipe(jl, japps.PAPER_SPEC, name=name, **kw)
    x, tgt = _x(dims, n=4, seed=1), _t(4, dims[-1], 5)
    for p in (pipe, jpipe):
        p.serve(x)
        p.train_step(x, tgt, lr=0.1, n_micro=2)
    rep = pipe.report()
    errs = rep.compare_hw()
    assert {"beat", "serve_energy", "serve_latency", "serve_throughput",
            "serve_link_bits", "train_step_time", "train_energy",
            "train_link_bits_fwd", "train_link_bits_bwd",
            "span"} <= set(errs)
    for k, v in errs.items():
        assert v <= 0.01, (name, k, v)
    jrep = jpipe.report()
    assert errs == jrep.compare_hw()
    assert rep.rows() == jrep.rows()
    assert (rep.span_us, rep.bubble_fraction, rep.link_utilization,
            rep.cores_per_chip, rep.stage_groups) == \
        (jrep.span_us, jrep.bubble_fraction, jrep.link_utilization,
         jrep.cores_per_chip, jrep.stage_groups)


def test_boundary_link_bits_follow_the_noc_quantization_rule():
    """Forward crossings are 3-bit ADC codes, backward crossings 8-bit
    sign-magnitude codes, per boundary activation line — measured."""
    _, np_layers = _layers(MNIST)
    pipe = _pipe(np_layers, n_chips=2)
    x = _x(MNIST, n=4)
    pipe.train_step(x, x[:, :MNIST[-1]], lr=0.1)
    b = sum(pipe.boundary_dims)
    assert pipe.link.fwd_bits_per_sample() == b * thw.ADC_BITS_OUT
    assert pipe.link.bwd_bits_per_sample() == b * thw.ERR_BITS_LINK
    rep = pipe.report()
    assert rep.link_bits_fwd == rep.analytic.link_bits_fwd
    assert rep.link_bits_bwd == rep.analytic.link_bits_bwd


def test_per_chip_counters_partition_the_serial_chip():
    """The slice counters are a partition: summed per-sample train time
    across slices equals the serial chip's measured train time."""
    _, np_layers = _layers(MNIST)
    pipe, chip = _pipe(np_layers, n_chips=2), _chip(np_layers)
    x = _x(MNIST, n=2)
    pipe.train_step(x, x[:, :MNIST[-1]], lr=0.1)
    chip.train_step(x, x[:, :MNIST[-1]], lr=0.1)
    split_sum = sum(c.train_counters.time_us() for c in pipe.chips)
    assert split_sum == pytest.approx(chip.train_counters.time_us())
    for phase in ("fwd", "bwd", "update"):
        assert sum(c.train_counters.slots[phase] for c in pipe.chips) == \
            chip.train_counters.slots[phase]
        assert sum(c.train_counters.core_steps[phase]
                   for c in pipe.chips) == \
            chip.train_counters.core_steps[phase]


def test_indivisible_microbatches_are_refused():
    _, np_layers = _layers(KDD)
    pipe = _pipe(np_layers, n_chips=2)
    x = _x(KDD, n=4)
    with pytest.raises(ValueError, match="not divisible"):
        pipe.train_step(x, x, lr=0.1, n_micro=3)
    assert pipe.version == 0 and pipe.train_steps == 0


# ---------------------------------------------------------------------------
# Pipeline x farm composition (farm of pipelines)
# ---------------------------------------------------------------------------

def test_pipeline_farm_composition_lockstep():
    """N pipeline replicas trained data-parallel stay bit for bit in
    lockstep AND match the serial chip (the farm's bar) — both scaling
    axes compose without touching the numerics."""
    jl, np_layers = _layers(MNIST)
    pf = PipelineFarm(interop.layers_from_numpy(np_layers, "cpu"), SPEC,
                      n_pipelines=2, n_chips=2, device="cpu")
    chip = _chip(np_layers)
    jpf = JaxPipeFarm(jl, japps.PAPER_SPEC, n_pipelines=2, n_chips=2)
    assert pf.total_chips == 4 and pf.groups == jpf.groups
    x, tgt = _x(MNIST, n=4), _t(4, MNIST[-1], 4)
    counts = plain_counts(chip.layers(), x, tgt, 0.1)
    ef = pf.train_step(x, tgt, lr=0.1)
    ec = chip.train_step(x, tgt, lr=0.1)
    np.testing.assert_allclose(_np(ef), _np(ec), atol=G_ATOL)
    assert pf.replicas_in_sync()
    assert_layers_match(pf.layers(), chip.layers(), counts)
    ej = jpf.train_step(x, tgt, lr=0.1)
    np.testing.assert_allclose(_np(ef), np.asarray(ej), atol=ATOL)
    assert_layers_match(pf.layers(), jpf.layers(), counts)
    out, stats = pf.serve(x)
    ref = txb.mlp_forward(pf.layers(), x, SPEC, device="cpu")
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)
    _, jstats = jpf.serve(x)
    assert stats == jstats
    # pipeline-axis link metering matches the analytic boundary bits
    frep, plink = pf.report()
    pc = thw.pipeline_cost("mnist_class", MNIST, n_chips=2, batch=4)
    assert plink["link_bits_fwd"] == pc.link_bits_fwd
    assert plink["link_bits_bwd"] == pc.link_bits_bwd
    assert plink == jpf.report()[1]
    assert dataclasses.astuple(pf.link) == dataclasses.astuple(jpf.link)
    # and the DP axis still meets the farm contract
    errs = {**frep.compare_chip_sum(), **frep.compare_hw()}
    assert all(v <= 0.01 for v in errs.values()), errs


def test_build_pipeline_helper():
    pipe = build_pipeline("mnist_class", n_chips=2, seed=1, device="cpu")
    assert pipe.n_chips == 2 and pipe.compiled
    x = _x(MNIST, n=2)
    out = pipe.infer(x)
    assert tuple(out.shape) == (2, 10)
    # the same draw as build_chip / build_farm: one seeded CPU generator
    from repro_torch.launch.chipsim import build_chip
    chip = build_chip("mnist_class", seed=1, device="cpu")
    assert torch.equal(out, chip.infer(x))
    eager = build_pipeline("mnist_class", n_chips=2, seed=1, device="cpu",
                           compiled=False)
    assert not any(c.compiled for c in eager.chips)


def test_cli_check_serial_on_cpu(tmp_path, capsys):
    """``launch.pipeline --check-serial`` holds every step bit for bit
    against the serial chip and cross-validates within 1 %."""
    from repro_torch.launch import pipeline
    out = tmp_path / "pipe.json"
    pipeline.main(["--app", "isolet_class", "--device", "cpu",
                   "--check-serial", "--json", str(out)])
    text = capsys.readouterr().out
    assert "split over 2 chips (cores/chip [130, 30]" in text
    assert "vs serial chip: 0.00e+00, conductances equal" in text
    assert "cross-validation vs pipeline_cost" in text and out.exists()
    pipeline.main(["--app", "mnist_class", "--device", "cpu",
                   "--pipeline-chips", "3", "--n-micro", "2", "--batch",
                   "4", "--train-steps", "2", "--requests", "3",
                   "--check-serial"])
    text = capsys.readouterr().out
    assert "train step 1" in text and "conductances equal" in text
