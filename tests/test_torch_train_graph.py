"""The captured training steps on the CPU: ``runtime.train_loop.TrainStep``
(the ``Trainer``'s step) and ``PaperTrainStep`` (``make_paper_train_step``),
the optimizers' host scalars, and the capture rules with a CPU stand-in
for ``graphs.Graph``.

On the card each step is one captured CUDA graph whose replays read the
batch and the optimizer's step scalars (the learning rate, adamw's bias
corrections) from static buffers; ``chip_smoke.py`` holds the captured
steps against the eager ones there.  Here the stand-in runs the captured
body again on each replay, on the buffers the capture bound, which is
what a replay computes.

Tolerances: none, except against the reference's scan step, held as
``tests/test_torch_crossbar_train.py`` holds the port's scan (its bars
and its excuse of cells next to a half pulse).  The steps, the stand-in
replays and the tensor-scalar updates equal their eager and Python-float
forms bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import crossbar as jxb  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist.sharding import tree_leaves  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw, pulse_sgd, sgd  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

import test_torch_serve_graph as serve_graph  # noqa: E402
from test_torch_crossbar_train import (STEP_CASES, _specs,  # noqa: E402
                                       _step_data, _torch_layers,
                                       assert_layers_match, plain_counts)

ARCH = "qwen2-0.5b"


class ReplayOnCpu(serve_graph.ReplayOnCpu):
    """``tests/test_torch_serve_graph.py``'s CPU stand-in for
    ``graphs.Graph``, which also takes the generators a ``TrainStep``
    registers."""

    def __init__(self, body, device, generators=()):
        super().__init__(body, device)
        self.generators = generators


def _clone(tree):
    return [t.clone() for t in tree_leaves(tree)]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _model_state(opt, arch=ARCH, **kw):
    trainer = Trainer(get_reduced_config(arch, **kw), opt, device="cpu")
    state = trainer.init_state()
    return trainer, state.params, state.opt_state


def _run(step, params, opt_state, stream, n, first=0):
    hist = []
    for s in range(first, first + n):
        params, opt_state, m = step(params, opt_state, stream.batch_at(s), s)
        hist.append({k: v.clone() for k, v in m.items()})
    return params, opt_state, hist


# ---------------------------------------------------------------------------
# TrainStep against make_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_on_the_cpu_is_make_train_step(grad_accum):
    """On the CPU ``TrainStep`` calls the eager step: 2 steps equal
    ``make_train_step``'s bit for bit, parameters, state and metrics."""
    opt = adamw(cosine_schedule(3e-3, 1, 4))
    runs = []
    for wrap in (True, False):
        trainer, params, state = _model_state(opt)
        step = (ttrain.TrainStep(trainer.model, opt, grad_accum=grad_accum)
                if wrap else ttrain.make_train_step(trainer.model, opt,
                                                    grad_accum=grad_accum))
        stream = TokenStream(trainer.cfg.vocab_size, 32, 4, seed=3)
        params, state, hist = _run(step, params, state, stream, 2)
        runs.append((_clone(params), _clone(state), hist))
        if wrap:
            assert not step.compiled and step.captures == 0
    assert _equal(runs[0][0], runs[1][0]) and _equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a[k], b[k])
               for a, b in zip(runs[0][2], runs[1][2]) for k in a)


def test_trainer_runs_its_train_step():
    """``Trainer.run`` calls ``trainer.train_step``, which is the
    ``TrainStep`` ``trainer.step``; setting it to ``step.fn`` trains
    eagerly to the same bits."""
    cfg = get_reduced_config(ARCH)
    out = []
    for eager in (False, True):
        trainer = Trainer(cfg, adamw(3e-3), device="cpu")
        assert trainer.train_step is trainer.step
        assert isinstance(trainer.step, ttrain.TrainStep)
        if eager:
            trainer.train_step = trainer.step.fn
        state, hist = trainer.run(TokenStream(cfg.vocab_size, 32, 4, seed=0),
                                  3, log_every=100)
        out.append((_clone(state.params), [h["loss"] for h in hist]))
    assert _equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


# ---------------------------------------------------------------------------
# host scalars
# ---------------------------------------------------------------------------

def test_host_scalars_are_bias_corrections_and_schedule():
    """``opt.scalars(step)`` is the learning rate of the schedule and
    adamw's float32 bias corrections (``_bias_correction``) at t = step +
    1; ``device_scalars`` holds the same values in 0-d float64 tensors."""
    lr = cosine_schedule(1e-3, 3, 10)
    opt = adamw(lr, b1=0.9, b2=0.95)
    for step in (0, 1, 2, 7, 4999):
        host = opt.scalars(step)
        assert host == {"lr": lr(step),
                        "bc1": topt._bias_correction(0.9, step + 1),
                        "bc2": topt._bias_correction(0.95, step + 1)}
        dev = topt.device_scalars(host, torch.device("cpu"))
        assert all(t.dtype == torch.float64 and t.dim() == 0
                   and float(t) == host[k] for k, t in dev.items())
    assert sgd(lr).scalars(5) == pulse_sgd(lr).scalars(5) == {"lr": lr(5)}


def test_captured_step_buffers_hold_each_steps_scalars(monkeypatch):
    """Each replay's buffers hold the host scalars of its own step."""
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    lr = cosine_schedule(3e-3, 2, 6)
    opt = adamw(lr)
    trainer, params, state = _model_state(opt)
    step = ttrain.TrainStep(trainer.model, opt)
    step.compiled = True
    stream = TokenStream(trainer.cfg.vocab_size, 32, 4, seed=0)
    for s in range(4):
        params, state, _ = step(params, state, stream.batch_at(s), s)
        host = opt.scalars(s)
        assert {k: float(v) for k, v in step._scalars.items()} == host
    assert step.captures == 1


# the expressions the optimizers applied with Python floats
def _adamw_floats(grads, m, v, params, lr, b1, b2, eps, wd, step):
    t = step + 1
    bc1, bc2 = (topt._bias_correction(b, t) for b in (b1, b2))
    for p, m_, v_, g in zip(params, m, v, grads):
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * g * g)
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if wd:
            u = u + wd * p
        p.sub_(lr * u)


def _leaves(dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dtype) for s in ((64, 32), (32,), (7, 5, 3))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_scalars_update_equals_float_scalars(dtype):
    """adamw, sgd and pulse_sgd with their step scalars as 0-d float64
    tensors equal the same expressions with Python floats, bit for bit,
    on float32 and bfloat16 leaves, over 3 steps (a schedule and a plain
    lr that is no float32 value)."""
    for lr in (cosine_schedule(1e-3, 1, 5), 1e-3):
        lr_at = lambda s: lr(s) if callable(lr) else lr     # noqa: E731
        # adamw
        opt = adamw(lr, weight_decay=0.1)
        params, ref = _leaves(dtype, 0), _leaves(dtype, 0)
        state = opt.init({"a": params})
        m = [torch.zeros_like(p) for p in ref]
        v = [torch.zeros_like(p) for p in ref]
        for s in range(3):
            grads = _leaves(dtype, 10 + s)
            opt.update({"a": grads}, state, {"a": params}, step=s)
            _adamw_floats(grads, m, v, ref, lr_at(s), 0.9, 0.95, 1e-8, 0.1,
                          s)
        assert _equal(params, ref) and _equal(state["m"]["a"], m) and \
            _equal(state["v"]["a"], v), ("adamw", dtype, lr)
        # sgd with momentum
        opt = sgd(lr, momentum=0.9)
        params, ref = _leaves(dtype, 1), _leaves(dtype, 1)
        state = opt.init({"a": params})
        mu = [torch.zeros_like(p) for p in ref]
        for s in range(3):
            grads = _leaves(dtype, 20 + s)
            opt.update({"a": grads}, state, {"a": params}, step=s)
            for p, m_, g in zip(ref, mu, grads):
                m_.mul_(0.9).add_(g)
                p.sub_(lr_at(s) * m_)
        assert _equal(params, ref), ("sgd", dtype, lr)
        # pulse_sgd, conductance leaves clipped
        opt = pulse_sgd(lr, max_update=0.05, levels=128, w_max=4.0)
        params = {"g_plus": _leaves(dtype, 2)}
        ref = _leaves(dtype, 2)
        for s in range(3):
            grads = {"g_plus": [g * 40 for g in _leaves(dtype, 30 + s)]}
            opt.update(grads, {}, params, step=s)
            for p, g in zip(ref, grads["g_plus"]):
                p.add_(tq.pulse_discretize(-lr_at(s) * g, 0.05, 128, None))
                p.clamp_(0.0, 4.0)
        assert _equal(params["g_plus"], ref), ("pulse_sgd", dtype, lr)


def test_stochastic_pulse_rounding_draws_from_the_generator():
    """``make_train_step(generator=)`` hands the generator to pulse_sgd:
    two runs from equal generators give equal steps, and they differ from
    round-to-nearest."""
    opt = pulse_sgd(0.5)
    out = []
    for gen in (torch.Generator().manual_seed(5),
                torch.Generator().manual_seed(5), None):
        trainer, params, state = _model_state(opt)
        step = ttrain.TrainStep(trainer.model, opt, generator=gen)
        stream = TokenStream(trainer.cfg.vocab_size, 32, 4, seed=0)
        params, _, _ = _run(step, params, state, stream, 2)
        out.append(_clone(params))
    assert _equal(out[0], out[1]) and not _equal(out[0], out[2])


# ---------------------------------------------------------------------------
# the capture rules (CPU stand-in)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_stand_in_replays_equal_the_eager_steps(monkeypatch, grad_accum):
    """A step captured once and replayed 2 times equals 3 eager steps bit
    for bit (parameters, adamw state, metrics)."""
    opt = adamw(cosine_schedule(3e-3, 1, 4))
    trainer, p_e, s_e = _model_state(opt)
    stream = TokenStream(trainer.cfg.vocab_size, 32, 4, seed=1)
    p_e, s_e, h_e = _run(ttrain.make_train_step(trainer.model, opt,
                                                grad_accum=grad_accum),
                         p_e, s_e, stream, 3)
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    trainer, p_c, s_c = _model_state(opt)
    step = ttrain.TrainStep(trainer.model, opt, grad_accum=grad_accum)
    step.compiled = True
    p_c, s_c, h_c = _run(step, p_c, s_c, stream, 3)
    assert step.captures == 1
    assert _equal(_clone(p_c), _clone(p_e))
    assert _equal(_clone(s_c), _clone(s_e))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(h_c, h_e) for k in a)


def test_replaced_leaf_or_batch_shape_captures_again(monkeypatch):
    """A restored (replaced) parameter or state leaf, or another batch
    shape, takes a new capture; the same tensors and shapes replay."""
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    opt = adamw(3e-3)
    trainer, params, state = _model_state(opt)
    step = ttrain.TrainStep(trainer.model, opt)
    step.compiled = True
    stream = TokenStream(trainer.cfg.vocab_size, 32, 4, seed=0)
    params, state, _ = _run(step, params, state, stream, 2)
    assert step.captures == 1
    params["embed"]["table"] = params["embed"]["table"].clone()
    params, state, _ = _run(step, params, state, stream, 2, first=2)
    assert step.captures == 2
    state["m"]["embed"]["table"] = state["m"]["embed"]["table"].clone()
    params, state, _ = _run(step, params, state, stream, 1, first=4)
    assert step.captures == 3
    wide = TokenStream(trainer.cfg.vocab_size, 16, 4, seed=0)
    params, state, _ = _run(step, params, state, wide, 1, first=5)
    assert step.captures == 4
    params, state, _ = _run(step, params, state, wide, 1, first=6)
    assert step.captures == 4


def test_resumed_trainer_captures_again_and_matches(monkeypatch, tmp_path):
    """A Trainer restored from a checkpoint captures again (its leaves are
    new tensors) and resumes bit for bit with an uninterrupted run."""
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    cfg = get_reduced_config(ARCH)
    stream = TokenStream(cfg.vocab_size, 32, 4, seed=0)

    def trainer(**kw):
        t = Trainer(cfg, adamw(cosine_schedule(3e-3, 1, 4)), device="cpu",
                    **kw)
        t.step.compiled = True
        return t

    full = trainer()
    want, _ = full.run(stream, 4, log_every=100)
    part = trainer(ckpt_dir=str(tmp_path), ckpt_every=2)
    part.run(stream, 2, log_every=100)
    resumed = trainer(ckpt_dir=str(tmp_path), ckpt_every=2)
    got, hist = resumed.run(stream, 4, log_every=100)
    assert [h["step"] for h in hist] == [3, 4]
    assert full.step.captures == part.step.captures == 1
    assert resumed.step.captures == 1
    assert _equal(_clone(got.params), _clone(want.params))
    assert _equal(_clone(got.opt_state), _clone(want.opt_state))


def test_moe_routing_records_replay(monkeypatch):
    """Where ``layers.moe.ROUTING`` is a list, the capture's records leave
    it and each replay appends clones of them: 3 steps leave one record a
    moe layer a step, as the eager steps do.  Here the capture runs the
    body's Python, as a capture does, and then puts the parameters and
    the state back (a capture executes nothing)."""
    state_leaves: list = []

    class Capturing(ReplayOnCpu):
        def capture(self):
            saved = [t.clone() for t in state_leaves]
            self.body()
            for t, v in zip(state_leaves, saved):
                t.copy_(v)

    monkeypatch.setattr(graphs, "Graph", Capturing)
    opt = adamw(3e-3)
    trainer, params, state = _model_state(opt, arch="qwen3-moe-30b-a3b")
    state_leaves.extend(tree_leaves(params) + tree_leaves(state))
    step = ttrain.TrainStep(trainer.model, opt)
    step.compiled = True
    stream = TokenStream(trainer.cfg.vocab_size, 16, 2, seed=0)
    tmoe.ROUTING = []
    try:
        _run(step, params, state, stream, 3)
        routes = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    n_moe = trainer.cfg.layer_kinds().count("moe")
    assert step.captures == 1
    assert n_moe > 0 and len(routes) == 3 * n_moe
    assert routes[n_moe].top_i is not routes[2 * n_moe].top_i


# ---------------------------------------------------------------------------
# the paper's scan step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["stack_24x3_b16",
                                  "stack_20x2_b8_continuous"])
def test_paper_train_step_is_the_reference_scan(name, use_kernel):
    """``make_paper_train_step``'s step on the CPU against the reference's
    jitted ``paper_backprop_step_scan``, one step from equal layers."""
    c = STEP_CASES[name]
    sj, st = _specs(**c["spec"])
    jl, x, t = _step_data(c)
    want, want_err = jxb.paper_backprop_step_scan(
        jxb.stack_layers(jl), x, t, sj, c["lr"], use_kernel)
    tl = _torch_layers(jl)
    counts = plain_counts(tl, x, t, st, c["lr"])
    step = ttrain.make_paper_train_step(st, c["lr"], use_kernel=use_kernel)
    assert isinstance(step, ttrain.PaperTrainStep)
    stacked = txb.stack_layers(tl)
    got, err = step(stacked, {"x": torch.from_numpy(x),
                              "target": torch.from_numpy(t)})
    assert got is stacked and step.captures == 0
    np.testing.assert_allclose(err.numpy(), np.asarray(want_err), atol=1e-6)
    assert_layers_match(txb.unstack_layers(got), jxb.unstack_layers(want),
                        counts, pulsed=st.update_quant)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paper_stand_in_replays_equal_the_eager_scan(monkeypatch, use_kernel):
    """One capture a stack: 4 replayed steps on new batches equal 5 eager
    ``paper_backprop_step_scan`` steps bit for bit (stacks and errors);
    another stack of the same shapes captures again."""
    c = STEP_CASES["stack_24x3_b16"]
    _, st = _specs(**c["spec"])
    jl, x, t = _step_data(c)
    rng = np.random.default_rng(4)
    batches = [{"x": torch.from_numpy(rng.uniform(-.5, .5, x.shape)
                                      .astype(np.float32)),
                "target": torch.from_numpy(rng.uniform(-.5, .5, t.shape)
                                           .astype(np.float32))}
               for _ in range(5)]
    eager = txb.stack_layers(_torch_layers(jl))
    errs = []
    for b in batches:
        _, err = txb.paper_backprop_step_scan(eager, b["x"], b["target"], st,
                                              c["lr"], use_kernel)
        errs.append(err.clone())
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    step = ttrain.make_paper_train_step(st, c["lr"], use_kernel=use_kernel)
    step.compiled = True
    stacked = txb.stack_layers(_torch_layers(jl))
    for b, want in zip(batches, errs):
        got, err = step(stacked, b)
        assert got is stacked and torch.equal(err, want)
    assert step.captures == 1
    assert all(torch.equal(stacked[k], eager[k]) for k in eager)
    other = {k: v.clone() for k, v in stacked.items()}
    step(other, batches[0])
    assert step.captures == 2
