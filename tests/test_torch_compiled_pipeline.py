"""Port against port: the compiled pipeline fabric (``ChipPipeline``'s
default, each slice's wave and backward pass one program,
``PipelineServer``'s session one captured beat) against the eager one
(``compiled=False``), on the CPU where the programs run the kernels'
plain versions.  Bit for bit throughout: steps, waves and serving
sessions of compiled and eager pipelines; a stage inside its slice's
envelope and inside the full network's; and the conductances every
consumer of the shared placement sees after compiled and eager steps
(the slices alias the full placement's `Stage` objects, whose version the
fabric bumps).  Build counts: one program per (slice, program, shape).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.configs.paper_apps import PAPER_SPEC  # noqa: E402
from repro_torch.launch.chipsim import build_chip  # noqa: E402
from repro_torch.runtime.serve_loop import RequestQueue  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402
from repro_torch.sim import compiled as csim  # noqa: E402
from repro_torch.sim.fabric import PipelineServer, build_pipeline  # noqa: E402

LR = 0.1
CASES = {
    # app, split, batch: the default 144-core split of isolet (2 chips,
    # 130 + 30 cores) and the ragged 3-way split of mnist (1/1/2)
    "isolet_class": ({}, 6),
    "mnist_class": (dict(n_chips=3), 8),
}


def _data(pipe, n, seed):
    g = torch.Generator().manual_seed(seed)
    dims = pipe.placement.dims
    return (torch.rand((n, dims[0]), generator=g) - 0.5,
            torch.rand((n, dims[-1]), generator=g) - 0.5)


def _pair(app):
    kw, _ = CASES[app]
    return (build_pipeline(app, seed=0, device="cpu", **kw),
            build_pipeline(app, seed=0, device="cpu", compiled=False, **kw))


def _equal_layers(a, b) -> bool:
    return all(torch.equal(p[k], q[k]) for p, q in zip(a, b)
               for k in ("g_plus", "g_minus"))


@pytest.mark.parametrize("app", sorted(CASES))
def test_compiled_step_equals_eager_step(app):
    """Two steps (the second 1F1B-microbatched): errors, conductances
    and every slice's counters bit for bit; the eager path takes no
    program."""
    comp, eager = _pair(app)
    assert comp.groups == eager.groups
    csim.reset_capture_counts()
    for step in range(2):
        x, t = _data(comp, CASES[app][1], 10 + step)
        ec = comp.train_step(x, t, LR, n_micro=step + 1)
        programs = csim.capture_counts()
        ee = eager.train_step(x, t, LR, n_micro=step + 1)
        assert csim.capture_counts() == programs
        assert torch.equal(ec, ee)
        assert _equal_layers(comp.layers(), eager.layers())
    for a, b in zip(comp.chips, eager.chips):
        assert a.train_counters.slots == b.train_counters.slots
        assert a.train_counters.core_steps == b.train_counters.core_steps
        assert a.train_counters.io_bits == b.train_counters.io_bits
    assert comp.link == eager.link
    assert comp.report().compare_hw() == eager.report().compare_hw()


@pytest.mark.parametrize("app", sorted(CASES))
def test_compiled_session_equals_eager_server(app):
    """The captured serving session (one launch a beat over every stage's
    cores) against the eager per-chip server on the same conductances:
    outputs, stats, counters and link bits equal; both equal the wave."""
    comp, eager = _pair(app)
    x, _ = _data(comp, 10, 3)
    reqs = list(x.reshape(5, 2, -1))
    outs, stats = [], []
    for pipe in (comp, eager):
        queue = RequestQueue(reqs)
        stats.append(PipelineServer(pipe).run(queue))
        outs.append(torch.stack(queue.results()).reshape(10, -1))
    assert torch.equal(outs[0], outs[1]) and stats[0] == stats[1]
    S = len(comp.placement.stages)
    assert stats[0]["beats"] == S - 1 + 5 and stats[0]["retired"] == 10
    assert torch.equal(outs[0], comp.infer(x, count=False))
    for a, b in zip(comp.chips, eager.chips):
        assert a.infer_counters.slots == b.infer_counters.slots
        assert a.infer_counters.core_steps == b.infer_counters.core_steps
        assert a.infer_counters.samples == b.infer_counters.samples
        assert a.infer_counters.io_bits == b.infer_counters.io_bits
        assert a.infer_counters.noc.link_utilization == \
            b.infer_counters.noc.link_utilization
    assert comp.link == eager.link
    assert (comp.serve_beats, comp.serve_samples, comp.serve_full_beats,
            comp.serve_slot_m) == (eager.serve_beats, eager.serve_samples,
                                   eager.serve_full_beats,
                                   eager.serve_slot_m)


def test_one_program_per_slice_program_and_shape():
    """The first step builds each slice's forward and backward programs
    (the forward keyed on its tail quantization), later steps and an lr
    change build none, a wave of the same batch reuses the forward, a new
    batch builds the next pair; a serving session builds one beat
    program, reused by the next session of the same shape."""
    pipe, _ = _pair("isolet_class")
    x, t = _data(pipe, 6, 1)
    csim.reset_capture_counts()
    for lr in (LR, LR, LR / 2):
        pipe.train_step(x, t, lr)
    counts = csim.capture_counts()
    assert len(counts) == 4 and set(counts.values()) == {1}
    assert sorted((k[0], k[-1]) for k in counts
                  if k[0] == "chip_forward") == [("chip_forward", False),
                                                 ("chip_forward", True)]
    assert sum(k[0] == "chip_backward" for k in counts) == 2
    pipe.infer(x)
    assert csim.capture_counts() == counts
    pipe.train_step(x[:3], t[:3], LR)
    assert len(csim.capture_counts()) == 8
    csim.reset_capture_counts()
    pipe.serve(x)
    pipe.serve(x + 0.125)
    assert list(csim.capture_counts().values()) == [1]
    assert next(iter(csim.capture_counts()))[0] == "serve_scan"


def test_slice_stage_equals_the_full_envelope_stage():
    """A slice runs its stages inside its own envelope (another T_max and
    N_pad than the unsplit chip's); every stage computes the same bits
    there as inside the full network's envelope — waves, dot products,
    the error leaving each slice and the updated conductances."""
    pipe, _ = _pair("isolet_class")
    full = build_chip("isolet_class", seed=0, device="cpu")
    slices = [c._get_stacks() for c in pipe.chips]
    whole = full._get_stacks()
    assert any(s.T_max != whole.T_max for s in slices)
    assert any(s.N_pad != whole.N_pad for s in slices)
    x, t = _data(pipe, 6, 2)
    fa, fd, fo = full.forward_wave(x, count=False)
    h, waves = x, []
    for k, chip in enumerate(pipe.chips):
        acts, dps, h = chip.forward_wave(h, count=False,
                                         quantize_tail=k < pipe.n_chips - 1)
        waves.append((acts, dps))
    assert all(torch.equal(a, b) for a, b in
               zip([a for acts, _ in waves for a in acts], fa))
    assert all(torch.equal(a, b) for a, b in
               zip([d for _, dps in waves for d in dps], fd))
    assert torch.equal(h, fo)
    err = full.train_step(x, t, LR)
    delta = t - h
    assert torch.equal(delta, err)
    for chip, (acts, dps) in zip(reversed(pipe.chips), reversed(waves)):
        delta = chip.backward_update(acts, dps, delta, LR,
                                     global_batch=x.shape[0])
    assert _equal_layers(pipe.layers(), full.layers())


@pytest.mark.parametrize("compiled", [True, False])
def test_every_consumer_sees_the_new_conductances(compiled):
    """The slices alias the full placement's `Stage` objects.  After a
    step (compiled: the slices' envelopes scattered back; eager: new
    stacks stored through the sub-placements) the fabric bumps its own
    and the full placement's version, so ``layers()``, ``infer``, a
    fresh serving session and a chip built on ``pipe.placement`` before
    the step all see the new conductances; and a step of that chip
    reaches the slices in turn."""
    pipe = build_pipeline("mnist_class", n_chips=2, seed=0, device="cpu",
                          compiled=compiled)
    serial = build_chip("mnist_class", seed=0, device="cpu")
    onto = VirtualChip(None, PAPER_SPEC, placement=pipe.placement,
                       device="cpu", compiled=compiled)
    x, t = _data(pipe, 4, 5)
    before = onto.infer(x, count=False)
    for chip in pipe.chips:       # the slices' stages ARE the full ones
        assert all(any(s is p for p in pipe.placement.stages)
                   for s in chip.placement.stages)
    v = pipe.placement.version
    pipe.train_step(x, t, LR)
    serial.train_step(x, t, LR)
    assert pipe.version == 1 and pipe.placement.version > v
    assert _equal_layers(pipe.layers(), serial.layers())
    after = serial.infer(x, count=False)
    assert not torch.equal(after, before)
    assert torch.equal(pipe.infer(x, count=False), after)
    assert torch.equal(onto.infer(x, count=False), after)
    # a session serves one-row requests: on the CPU the plain product at
    # M = 1 may sum in another order than at M = 4, so within 1e-6 here
    out, _ = pipe.serve(x)
    assert float((out - after).abs().max()) <= 1e-6 \
        < float((before - after).abs().max())
    ref = txb.mlp_forward(serial.layers(), x, PAPER_SPEC, device="cpu")
    assert float((out - ref).abs().max()) <= 1e-5
    # a write through the full placement reaches the slices
    onto.train_step(x, t, LR)
    serial.train_step(x, t, LR)
    assert _equal_layers(pipe.layers(), serial.layers())
    assert torch.equal(pipe.infer(x, count=False),
                       serial.infer(x, count=False))
    pipe.train_step(x, t, LR)
    serial.train_step(x, t, LR)
    assert _equal_layers(pipe.layers(), serial.layers())
    assert pipe.version == 2
