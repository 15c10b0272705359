"""Port parity: ``repro_torch.optim`` (sgd, adamw, pulse_sgd, the
schedules) against ``repro.optim`` on the same numpy arrays, and the
statements of ``repro.data.pipeline.TokenStream`` held port against port
(after ``tests/test_data_optim.py``).

Tolerances, each with its reason:
- schedules: equal within one float32 ulp (both compute in float32; the
  cosine's libm may differ in the last bit).
- sgd and adamw: 1e-6 absolute plus 1e-6 relative over five steps (the
  same float32 operations in the same order; a schedule's value may
  differ in the last bit, and the reference under ``jit`` may contract a
  product and a sum).
- adamw's bias corrections: bit for bit against ``jax.jit`` of the
  reference's expression at ``jnp.int32`` steps 0-4999, as the
  reference's ``Trainer`` and ``dp_train_step_fn`` take them.
- pulse_sgd: every pulse count equal, except where the reference's
  unrounded count lies within 1e-4 of a half-integer (counted; none in
  these draws), so parameters within 1e-6.
- TokenStream draws from a ``torch.Generator``, not ``jax.random``: its
  batches are held to the reference's statements, not to its tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist.sharding import tree_map  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "blk": ({"b": (rng.standard_normal(5) * scale).astype(
                np.float32)},),
            "scale": (1 + rng.standard_normal(3) * scale).astype(np.float32)}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_close(got, want, what):
    got = tree_map(lambda t: t.numpy(), got)
    flat_w = jax.tree.leaves(want)
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g), what
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda lib: lib.linear_warmup(3e-3, 10),
    lambda lib: lib.linear_warmup(1.0, 1),
    lambda lib: lib.cosine_schedule(3e-3, 5, 100),
    lambda lib: lib.cosine_schedule(1.0, 5, 100, final_frac=0.1),
    lambda lib: lib.cosine_schedule(0.7, 1, 3, final_frac=0.0),
])
def test_schedules_match_reference(make):
    want, got = make(jsched), make(tsched)
    for step in list(range(0, 12)) + [50, 99, 100, 150]:
        w, g = np.float32(want(step)), np.float32(got(step))
        assert isinstance(got(step), float)
        assert abs(g - w) <= np.spacing(w), (step, g, w)


def test_schedules_shape():
    lr = tsched.linear_warmup(1.0, 10)
    assert lr(0) == pytest.approx(0.1) and lr(9) == pytest.approx(1.0)
    cs = tsched.cosine_schedule(1.0, 5, 100, final_frac=0.1)
    assert cs(100) == pytest.approx(0.1, rel=1e-2)
    assert cs(50) > cs(99)


# ---------------------------------------------------------------------------
# sgd and adamw: five steps from the same parameters and gradients
# ---------------------------------------------------------------------------

OPTS = {
    "sgd momentum": lambda lib: lib.sgd(0.1),
    "sgd plain": lambda lib: lib.sgd(0.1, momentum=0.0),
    "sgd weight decay": lambda lib: lib.sgd(0.05, weight_decay=0.01),
    "adamw": lambda lib: lib.adamw(0.2),
    "adamw schedule + decay": lambda lib: lib.adamw(
        (jsched if lib is jopt else tsched).cosine_schedule(3e-3, 2, 10),
        weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_steps_match_reference(name):
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    p0 = _tree(0)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    ids = [id(t) for t in jax.tree.leaves(tree_map(lambda t: t, tp))]
    for step in range(5):
        g = _tree(10 + step, scale=0.5)
        jp, js = jo.update(_jax(g), js, jp, step=step)
        tp, ts = to.update(_torch(g), ts, tp, step=step)
        _assert_close(tp, jp, f"{name} params, step {step}")
        _assert_close(ts, js, f"{name} state, step {step}")
    # the update wrote the parameters in place (the port's donation)
    assert [id(t) for t in jax.tree.leaves(tree_map(lambda t: t, tp))] \
        == ids


@pytest.mark.parametrize("b", [0.9, 0.95])
def test_adamw_bias_correction_is_the_jitted_references(b):
    """``1 - b ** t`` at t = step + 1 as the reference's jitted update
    computes it at an int32 step (float32), bit for bit."""
    steps = jnp.arange(5000, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: 1 - b ** (s + 1)))(steps))
    assert want.dtype == np.float32
    got = np.array([topt._bias_correction(b, t + 1) for t in range(5000)],
                   dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    # the scalar jitted form the training step traces
    one = jax.jit(lambda s: 1 - b ** (s + 1))
    for t in (0, 1, 7, 99, 4999):
        assert topt._bias_correction(b, t + 1) == float(one(jnp.int32(t)))


@pytest.mark.parametrize("name", ["adamw", "adamw schedule + decay"])
def test_adamw_matches_the_jitted_reference_update(name):
    """Five updates of the reference's ``jax.jit(opt.update)`` at int32
    steps, as its training step runs them, beside the port's."""
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    p0 = _tree(0)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for step in range(5):
        g = _tree(10 + step, scale=0.5)
        jp, js = update(_jax(g), js, jp, step=jnp.int32(step))
        tp, ts = to.update(_torch(g), ts, tp, step=step)
        _assert_close(tp, jp, f"{name} params, step {step}")
        _assert_close(ts, js, f"{name} state, step {step}")


def _quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


@pytest.mark.parametrize("make", [lambda: topt.sgd(0.1),
                                  lambda: topt.adamw(0.2),
                                  lambda: topt.sgd(0.1, momentum=0.0)])
def test_optimizers_descend_quadratic(make):
    opt = make()
    params = {"w": torch.zeros(4), "b": torch.zeros(3)}
    state = opt.init(params)
    for step in range(100):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = dict(zip(live, torch.autograd.grad(_quad_loss(live),
                                               list(live.values()))))
        params, state = opt.update(g, state, params, step=step)
    assert float(_quad_loss(params)) < 0.1


# ---------------------------------------------------------------------------
# pulse_sgd: the pulse grid and the conductance clip
# ---------------------------------------------------------------------------

def test_pulse_sgd_matches_reference_and_clips():
    rng = np.random.default_rng(3)
    p0 = {"layer": {"g_plus": rng.uniform(0.9, 1.0, (8, 6)).astype(
              np.float32),
                    "g_minus": rng.uniform(0.0, 0.05, (8, 6)).astype(
              np.float32)},
          "other": rng.standard_normal(5).astype(np.float32)}
    jo = jopt.pulse_sgd(0.5, max_update=0.04, levels=8, w_max=1.0)
    to = topt.pulse_sgd(0.5, max_update=0.04, levels=8, w_max=1.0)
    jp, tp = _jax(p0), _torch(p0)
    unit = 0.04 / 8
    near = 0
    for step in range(3):
        g = {"layer": {"g_plus": rng.standard_normal((8, 6)).astype(
                 np.float32) * 0.02 - 0.03,
                       "g_minus": rng.standard_normal((8, 6)).astype(
                 np.float32) * 0.02 + 0.03},
             "other": rng.standard_normal(5).astype(np.float32) * 0.05}
        counts = jax.tree.map(lambda a: -0.5 * a / unit, g)
        for c in jax.tree.leaves(counts):
            near += int((np.abs(np.abs(c) % 1 - 0.5) < 1e-4).sum())
        jp, _ = jo.update(_jax(g), {}, jp, step=step)
        tp, _ = to.update(_torch(g), {}, tp, step=step)
        _assert_close(tp, jp, f"pulse_sgd step {step}")
    assert near == 0
    # conductances in [0, w_max]; the other leaf on the pulse grid, unclipped
    assert float(tp["layer"]["g_plus"].max()) <= 1.0
    assert float(tp["layer"]["g_minus"].min()) >= 0.0
    assert float(tp["layer"]["g_plus"].max()) == 1.0     # clipped
    k = (tp["other"].numpy() - p0["other"]) / unit
    assert np.allclose(k, np.round(k), atol=1e-3)


def test_pulse_sgd_stochastic_rounding_takes_a_generator():
    to = topt.pulse_sgd(0.5, max_update=0.04, levels=8, w_max=1.0)
    p = {"x": torch.zeros(4096)}
    g = {"x": torch.full((4096,), -0.0075)}     # 0.75 of a pulse
    unit = 0.04 / 8
    out, _ = to.update(g, {}, p, generator=torch.Generator().manual_seed(0))
    k = out["x"] / unit
    assert set(torch.round(k).tolist()) == {0.0, 1.0}
    assert abs(float(k.mean()) - 0.75) < 0.03
    again, _ = to.update(g, {}, {"x": torch.zeros(4096)},
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(again["x"], out["x"])


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "pulse_sgd"):
        assert topt.make_optimizer(name, 0.1).name == name


# ---------------------------------------------------------------------------
# TokenStream: the reference's statements, port against port
# ---------------------------------------------------------------------------

def test_stream_deterministic_and_restartable():
    ts = TokenStream(vocab_size=101, seq_len=16, global_batch=8, seed=5)
    b1, b2 = ts.batch_at(42), TokenStream(101, 16, 8, seed=5).batch_at(42)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert b1["tokens"].dtype == torch.int32
    assert b1["tokens"].shape == b1["labels"].shape == (8, 16)
    # labels are the tokens shifted by one
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 101
    assert not torch.equal(ts.batch_at(43)["tokens"], b1["tokens"])
    assert not torch.equal(TokenStream(101, 16, 8, seed=6).batch_at(42)[
        "tokens"], b1["tokens"])
    # a restarted iterator replays the same stream from its step
    it = ts.host_iterator(40)
    steps = [next(it) for _ in range(3)]
    assert [s for s, _ in steps] == [40, 41, 42]
    assert torch.equal(steps[2][1]["tokens"], b1["tokens"])


def test_stream_shards_partition_global_batch():
    ts = TokenStream(vocab_size=101, seq_len=8, global_batch=8, seed=1)
    shards = [ts.batch_at(3, shard=s, num_shards=4) for s in range(4)]
    assert all(b["tokens"].shape == (2, 8) for b in shards)
    assert not torch.equal(shards[0]["tokens"], shards[1]["tokens"])
    with pytest.raises(ValueError, match="split"):
        ts.batch_at(3, num_shards=3)


def test_stream_is_learnable_signal():
    """Motif windows repeat, so a bigram predictor beats chance."""
    ts = TokenStream(vocab_size=64, seq_len=128, global_batch=16, seed=0)
    toks = ts.batch_at(0)["tokens"].numpy()
    big = toks[:, :-1] * 64 + toks[:, 1:]
    _, counts = np.unique(big, return_counts=True)
    assert (counts > 3).sum() > 10


def test_stream_unigrams_are_zipfian():
    ts = TokenStream(vocab_size=1000, seq_len=255, global_batch=64, seed=2,
                     n_motifs=1, motif_len=1)
    toks = ts.batch_at(0)["tokens"].reshape(-1)
    freq = torch.bincount(toks.long(), minlength=1000).double()
    p = 1.0 / torch.arange(1, 1001, dtype=torch.float64)
    p /= p.sum()
    # rank 0 carries ~13 % of the mass, rank 9 a tenth of that
    assert abs(float(freq[0] / freq.sum()) - float(p[0])) < 0.01
    assert 5 < float(freq[0] / freq[9]) < 20
