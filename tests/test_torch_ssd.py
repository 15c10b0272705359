"""Port parity: the SSM family (mamba2-130m: the Mamba-2 ``ssd`` block,
its chunked SSD scan and its recurrent decode step) of ``repro_torch``
against ``repro``'s, on the CPU.

The layers (``_causal_conv``, ``_ssd_scan``, ``ssd_apply``'s prefill,
padded prefill, prefill into a cache and decode step) take the same numpy
inputs on both sides, the block's parameters drawn by the reference's
``init_params`` and carried across by ``interop.lm_params_from_numpy``;
the models take the reference's ``model.init(PRNGKey(0))`` parameters the
same way, at the reduced config (2 layers, d 64, 4 heads of 16, N 16,
chunk 32, G = 1) and at a ``ssm_groups=2`` variant, which pins the
head-to-group order (head h reads group h // (H / G)).

Tolerances, each with its reason:
- fp32 layers and the reduced model's logits, decode steps included:
  1e-5 absolute plus relative.  Both sides compute the same fp32 ops;
  sums run in other orders (XLA's ``cumsum`` on the CPU is a
  ``reduce_window`` whose order matches neither a sequential sum nor
  ``torch.cumsum``; einsums contract in other orders), and ``exp``,
  ``log1p`` differ in the last bit (softplus in ~10 % of outputs).
- the scan at mamba2-130m's full heads and chunk (L 512, H 24, P 64, N
  128, chunk 256): the cumulative dt·A reaches hundreds there, where an
  fp32 ulp is ~3e-5, and exp(cum_i - cum_j) takes the difference of two
  such sums, so 1e-5 has no headroom.  The port's distance from a
  float64 run of its own scan must be at most 2x the reference's
  distance from it (max |Δ| / max |ref|), which pins the full chunk
  without a bar tuned to pass.
- decode after prefill: the port's decode step within the reference's
  own 5e-3 of its own 17-token forward (``tests/test_layers.py``), and
  within 1e-5 of the reference's decode step.
- bf16 compute: the recurrence carries a state whose decay is close to
  1, so one bf16 rounding that lands a step apart moves every later
  logit of its row.  Logits are held in the Frobenius norm within the
  reference's own bf16 noise, ||port - ref|| <= ||ref - ref in float32
  compute|| (``_assert_within_bf16_noise``).
- loss and gradients: the bars of tests/test_torch_train_step.py (fp32:
  the loss within 1e-5 relative, each leaf within 1e-4 of its largest);
  in crossbar kernel mode a miss is excused only where the port's
  quantizers saw an input within 1e-4 of a code boundary (counted).
"""
import dataclasses
import functools
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jcfg  # noqa: E402
from repro.dist.sharding import init_params as jinit  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import ssd as tssd  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.checkpoint import _key, _walk  # noqa: E402
from test_torch_hybrid import _assert_within_bf16_noise  # noqa: E402
from test_torch_train_step import _NearBoundary, _flat_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "mamba2-130m"
TOL = 1e-5
FULL_COUNT = 129_100_224
VARIANTS = {"reduced": {}, "groups 2": {"ssm_groups": 2}}
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(4)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_and_param_count_equal_the_reference():
    for getter in ("get_config", "get_reduced_config"):
        jc = getattr(jcfg, getter)(ARCH)
        tc = getattr(tcfg, getter)(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.ssd()) == dataclasses.asdict(jc.ssd())
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == tc.param_count()
        assert tc.layer_kinds() == jc.layer_kinds()
    cfg = tcfg.get_config(ARCH)
    assert cfg.param_count() == FULL_COUNT
    assert tcfg.shape_applicable(cfg, "long_500k") == (True, "")
    lay = tlm.stack_layout(cfg)
    assert (lay.prefix, lay.pattern, lay.periods, lay.suffix) == (
        (), ("ssd",), 24, ())
    s = cfg.ssd()
    assert (s.d_inner, s.n_heads, s.conv_dim) == (1536, 24, 1792)
    assert cfg.padded_vocab == 50432
    grp = tcfg.get_reduced_config(ARCH, ssm_groups=2)
    assert grp.param_count() == jcfg.get_reduced_config(
        ARCH, ssm_groups=2).param_count()


# ---------------------------------------------------------------------------
# the conv, the scan and the block
# ---------------------------------------------------------------------------

def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    want = jax.jit(jssd._causal_conv)(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b))
    got = tssd._causal_conv(_t(x), _t(w), _t(b))
    _close(got, want)
    # causal: a change at t reaches no earlier position
    x2 = x.copy()
    x2[:, 20] += 1.0
    got2 = tssd._causal_conv(_t(x2), _t(w), _t(b))
    assert torch.equal(got2[:, :20], got[:, :20])


def _scan_inputs(B, L, H, P, G, N, seed=3):
    """The reference test's distributions (tests/test_layers.py), from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((B, L, H)).astype(np.float32) - 1)))
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


J_SCAN = jax.jit(jssd._ssd_scan, static_argnums=5)


def _sequential(x, dt, A, Bm, Cm):
    """The O(L) recurrence in float64 (the oracle of tests/test_layers.py)."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    rep = x.shape[2] // Bm.shape[2]
    S = np.zeros(x.shape[:1] + x.shape[2:] + Bm.shape[-1:])
    ys = []
    for t in range(x.shape[1]):
        Bt = np.repeat(Bm[:, t], rep, axis=1)
        Ct = np.repeat(Cm[:, t], rep, axis=1)
        S = S * np.exp(dt[:, t] * A[None])[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bt, x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Ct, S))
    return np.stack(ys, axis=1), S


@pytest.mark.parametrize("shape", [
    (2, 64, 4, 8, 2, 16, 16),       # the reference test's
    (2, 64, 8, 16, 1, 16, 32),      # the reduced config's heads and chunk
    (2, 64, 8, 16, 2, 16, 32),      # ... at G = 2
], ids=["reference test", "reduced", "reduced G=2"])
def test_ssd_scan_matches_the_reference(shape):
    B, L, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = _scan_inputs(B, L, H, P, G, N)
    want_y, want_S = J_SCAN(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    got_y, got_S = tssd._ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    assert got_y.dtype == got_S.dtype == torch.float32
    _close(got_y, want_y, what="y")
    _close(got_S, want_S, what="final state")
    # and the chunked form is the recurrence
    seq_y, seq_S = _sequential(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(_f32(got_y), seq_y, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_f32(got_S), seq_S, atol=1e-4, rtol=1e-4)


def test_ssd_scan_at_full_heads_and_chunk_against_float64():
    """mamba2-130m's heads and chunk (module docstring): the port no
    farther from float64 than 2x the reference's distance."""
    chunk = 256
    x, dt, A, Bm, Cm = _scan_inputs(1, 512, 24, 64, 1, 128, seed=0)
    want_y, want_S = J_SCAN(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    got_y, got_S = tssd._ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    y64, S64 = tssd._ssd_scan(*(_t(a).double() for a in (x, dt, A, Bm, Cm)),
                              chunk)
    assert y64.dtype == torch.float64
    for got, want, exact, what in ((got_y, want_y, y64, "y"),
                                   (got_S, want_S, S64, "state")):
        exact = exact.numpy()
        mag = np.abs(exact).max()
        port = np.abs(_f32(got).astype(np.float64) - exact).max() / mag
        ref = np.abs(np.asarray(want, np.float64) - exact).max() / mag
        print(f"{what}: port {port:.3e}, reference {ref:.3e} from float64")
        assert port <= 2 * ref, (what, port, ref)


SSD = dict(d_model=16, d_state=8, head_dim=8, expand=2)


def _ssd_params(G, chunk, seed=4):
    jc = jssd.SSDConfig(**SSD, n_groups=G, chunk=chunk)
    tc = tssd.SSDConfig(**SSD, n_groups=G, chunk=chunk)
    jp = jinit(jax.random.PRNGKey(seed), jssd.ssd_spec(jc))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def _x(B, L, seed=5):
    return (np.random.default_rng(seed).standard_normal((B, L, 16))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L,chunk", [(64, 16), (40, 16), (10, 16)],
                         ids=["chunk multiple", "padded", "below a chunk"])
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["no cache", "into a cache"])
def test_ssd_apply_prefill_matches_the_reference(G, L, chunk, with_cache):
    """float32 compute: L a chunk multiple, L = 40 at chunk 16 (24 padded
    steps at dt = 0) and L below the chunk; with a cache, its conv window
    (the last d_conv - 1 pre-conv inputs) and final state equal the
    reference's, written in place."""
    jc, jp, tc, tp = _ssd_params(G, chunk)
    x = _x(2, L)
    f32 = dict(compute_dtype=jnp.float32)
    jcache = jssd.init_ssd_cache(jc, 2) if with_cache else None
    want, jcache = jssd.ssd_apply(jp, jnp.asarray(x), jc, cache=jcache,
                                  **f32)
    tcache = (tssd.init_ssd_cache(tc, 2, device="cpu") if with_cache
              else None)
    buffers = ([t.data_ptr() for t in tcache.values()] if with_cache
               else None)
    got, out = tssd.ssd_apply(tp, _t(x), tc, cache=tcache,
                              compute_dtype=torch.float32)
    assert got.shape == (2, L, 16) and got.dtype == torch.float32
    _close(got, want)
    if not with_cache:
        assert out is None
        return
    assert out is tcache and [t.data_ptr() for t in out.values()] == buffers
    for key in ("conv", "state"):
        assert out[key].dtype == torch.float32
        _close(out[key], jcache[key], what=key)
    assert int(out["length"]) == int(jcache["length"]) == L


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_after_prefill(G):
    """Prefill 16 tokens into a cache, then decode the 17th (the reference
    test tests/test_layers.py::test_ssd_decode_consistent_with_prefill):
    the port's step within 5e-3 of its own 17-token forward's last row
    and within 1e-5 of the reference's step; the cache in place, equal to
    the reference's."""
    jc, jp, tc, tp = _ssd_params(G, chunk=8)
    x = _x(2, 17)
    f32 = dict(compute_dtype=jnp.float32)
    jcache = jssd.init_ssd_cache(jc, 2)
    _, jcache = jssd.ssd_apply(jp, jnp.asarray(x[:, :16]), jc, cache=jcache,
                               **f32)
    want, jcache = jssd.ssd_apply(jp, jnp.asarray(x[:, 16:]), jc,
                                  cache=jcache, **f32)
    tcache = tssd.init_ssd_cache(tc, 2, device="cpu")
    buffers = [t.data_ptr() for t in tcache.values()]
    f32 = dict(compute_dtype=torch.float32)
    tssd.ssd_apply(tp, _t(x[:, :16]), tc, cache=tcache, **f32)
    got, out = tssd.ssd_apply(tp, _t(x[:, 16:]), tc, cache=tcache, **f32)
    assert out is tcache and [t.data_ptr() for t in out.values()] == buffers
    _close(got, want)
    for key in ("conv", "state"):
        _close(out[key], jcache[key], what=key)
    assert int(out["length"]) == int(jcache["length"]) == 17
    full, _ = tssd.ssd_apply(tp, _t(x), tc, **f32)
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(full[:, 16]),
                               atol=5e-3, rtol=5e-3)


def test_short_prefill_into_a_cache_raises():
    """A prefill of 1 < L < d_conv - 1 tokens into a cache leaves too few
    conv inputs: the reference writes a 2-row window (``xbc[:, -3:]`` of 2
    rows) and its next decode fails on the shape; the port refuses it.
    L = 3 and a decode step (L = 1) are fine."""
    jc, jp, tc, tp = _ssd_params(1, chunk=8)
    x = _x(2, 3)
    f32 = dict(compute_dtype=jnp.float32)
    jcache = jssd.init_ssd_cache(jc, 2)
    _, jcache = jssd.ssd_apply(jp, jnp.asarray(x[:, :2]), jc, cache=jcache,
                               **f32)
    assert jcache["conv"].shape[1] == 2
    with pytest.raises((TypeError, ValueError)):
        jssd.ssd_apply(jp, jnp.asarray(x[:, 2:]), jc, cache=jcache, **f32)
    tcache = tssd.init_ssd_cache(tc, 2, device="cpu")
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        tssd.ssd_apply(tp, _t(x[:, :2]), tc, cache=tcache,
                       compute_dtype=torch.float32)
    assert int(tcache["length"]) == 0
    tssd.ssd_apply(tp, _t(x), tc, cache=tcache, compute_dtype=torch.float32)
    tssd.ssd_apply(tp, _t(x[:, :1]), tc, cache=tcache,
                   compute_dtype=torch.float32)
    assert int(tcache["length"]) == 4


def test_softplus_is_the_reference_softplus():
    """``ssd.softplus`` is ``jnp.logaddexp(x, 0)`` op for op, forward and
    backward: within 1e-6 relative of ``jax.nn.softplus`` and of its
    derivative (XLA's exp and log1p round otherwise than torch's on the
    CPU: ~9 % of outputs differ, by at most 2 ulps forward and 4
    backward, measured)."""
    x = np.random.default_rng(0).standard_normal(20000).astype(
        np.float32) * 6
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda v: jax.nn.softplus(v).sum()))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = tssd.softplus(xt)
    got.sum().backward()
    np.testing.assert_allclose(_f32(got), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6, atol=0)


def test_ssd_init_ranges():
    """``a_log`` = log U(1, 16), softplus(``dt_bias``) log-uniform in
    [dt_min, dt_max], ``d_skip`` ones, ``conv_w`` std 1/sqrt(d_conv),
    ``conv_b`` zeros, as the reference's initializers."""
    cfg = tssd.SSDConfig(d_model=768, n_groups=1)
    p = tshd.init_params(torch.Generator().manual_seed(0),
                         tssd.ssd_spec(cfg))
    assert p["a_log"].shape == p["dt_bias"].shape == (24,)
    a = p["a_log"].double()
    assert float(a.min()) >= 0.0 and float(a.max()) <= math.log(16.0)
    dt = tssd.softplus(p["dt_bias"].double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-6)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-6)
    assert torch.equal(p["d_skip"], torch.ones(24))
    assert torch.equal(p["conv_b"], torch.zeros(1792))
    assert abs(float(p["conv_w"].std()) - 0.5) < 0.02
    assert p["in_proj"]["w"].shape == (768, 3352)
    assert p["out_proj"]["w"].shape == (1536, 768)
    assert p["norm"]["scale"].shape == (1536,)
    # and the reference's draws land in the same ranges
    jp = jinit(jax.random.PRNGKey(0), jssd.ssd_spec(jssd.SSDConfig(
        d_model=768)))
    jdt = np.asarray(jax.nn.softplus(jp["dt_bias"]), np.float64)
    assert jdt.min() >= 1e-3 * (1 - 1e-6) and jdt.max() <= 1e-1 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(variant, compute_dtype, **mode):
    over = dict(VARIANTS[variant], compute_dtype=compute_dtype, **mode)
    jc = jcfg.get_reduced_config(ARCH, **over)
    tc = tcfg.get_reduced_config(ARCH, **over)
    jm, tm = jbuild(jc), tbuild(tc, "cpu")
    jm = dataclasses.replace(jm, prefill_fn=jax.jit(jm.prefill_fn),
                             decode_fn=jax.jit(jm.decode_fn))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=[(v, d) for v in VARIANTS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    return request.param + _models(*request.param)


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, L),
                                                dtype=np.int32)


def test_param_tree_carries_every_leaf(models):
    variant, _, jm, jp, tm, tp = models
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tshd.tree_leaves(tp)
    assert len(jleaves) == len(tleaves) > 0
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(_f32(b), np.asarray(a))
    spec = jax.tree.leaves(tm.abstract_params())
    assert [tuple(s.shape) for s in spec] == [a.shape for _, a in jleaves]
    blk = tp["stack"]["b0_ssd"]
    assert set(blk) == {"ln", "ssd"}
    assert set(blk["ssd"]) == {"in_proj", "conv_w", "conv_b", "a_log",
                               "d_skip", "dt_bias", "norm", "out_proj"}
    G = 2 if variant == "groups 2" else 1
    assert blk["ssd"]["in_proj"]["w"].shape == (2, 64, 256 + 32 * G + 8)
    assert blk["ssd"]["conv_w"].shape == (2, 4, 128 + 32 * G)
    assert "lm_head" not in tp                  # tied to the embedding
    back = interop.lm_params_to_numpy(tp)
    for (_, a), b in zip(jleaves, tshd.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("L", [64, 40], ids=["2 chunks", "padded"])
def test_prefill_matches_the_reference(models, L):
    variant, dtype, jm, jp, tm, tp = models
    tok = _tokens(2, L)
    want = jm.prefill_fn(jp, {"tokens": jnp.asarray(tok)})
    before = tops.flash_attention.launches
    got = tm.prefill_fn(tp, {"tokens": torch.from_numpy(tok)})
    assert tops.flash_attention.launches == before      # attention-free
    assert got.dtype == torch.float32 and got.shape == (2, L, 512)
    if dtype == "float32":
        _close(got, want)
    else:
        jm32, jp32, _, _ = _models(variant, "float32")
        want32 = jm32.prefill_fn(jp32, {"tokens": jnp.asarray(tok)})
        _assert_within_bf16_noise(got, want, want32)


def test_decode_matches_the_reference(models):
    """40 decode steps of the reduced model against the reference's, step
    by step (decode against decode: the chunked scan and the recurrent
    step are different algorithms); the cache is written in place and
    ends equal to the reference's in float32."""
    variant, dtype, jm, jp, tm, tp = models
    tok = _tokens(2, 40, 1)

    def ref_decode(jm, jp):
        jc, out = jm.init_cache(2, 48), []
        for step in range(40):
            logits, jc = jm.decode_fn(jp, jc, {
                "tokens": jnp.asarray(tok[:, step:step + 1]),
                "length": jnp.int32(step)})
            out.append(logits)
        return jnp.concatenate(out, axis=1), jc

    want, jc = ref_decode(jm, jp)
    tc = tm.init_cache(2, 48)
    blk = tc["stack"]["b0_ssd"]
    assert blk["state"].shape == (2, 2, 8, 16, 16)
    assert blk["state"].dtype == blk["conv"].dtype == torch.float32
    buffers = [t.data_ptr() for t in tshd.tree_leaves(tc)]
    got = []
    for step in range(40):
        logits, tc_out = tm.decode_fn(
            tp, tc, {"tokens": torch.from_numpy(tok[:, step:step + 1]),
                     "length": step})
        assert tc_out is tc
        got.append(logits)
    got = torch.cat(got, dim=1)
    assert [t.data_ptr() for t in tshd.tree_leaves(tc)] == buffers
    assert _f32(blk["length"]).tolist() == [40, 40]
    if dtype == "bfloat16":
        jm32, jp32, _, _ = _models(variant, "float32")
        _assert_within_bf16_noise(got, want, ref_decode(jm32, jp32)[0])
        return
    _close(got, want)
    for j, t in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        _close(t, j)


def test_decode_equals_prefill_in_the_port():
    """float32: 40 decode steps of the port within 1e-4 of its own
    40-token prefill (the recurrent step against the chunked scan)."""
    _, _, tm, tp = _models("reduced", "float32")
    tok = torch.from_numpy(_tokens(2, 40, 2))
    pre = tm.prefill_fn(tp, {"tokens": tok})
    cache, dec = tm.init_cache(2, 40), []
    for step in range(40):
        logits, cache = tm.decode_fn(tp, cache, {
            "tokens": tok[:, step:step + 1], "length": step})
        dec.append(logits)
    _close(torch.cat(dec, dim=1), pre, tol=1e-4)


MODES = {"standard": {},
         "kernel": dict(crossbar=True, xbar_use_kernel=True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_the_reference(variant, mode, monkeypatch):
    """float32 compute, remat "full" (the period and each scan chunk
    rematerialized): the loss and every gradient leaf (``a_log``,
    ``dt_bias``, ``d_skip``, ``conv_w``, ``conv_b`` and the projections)
    against ``jax.value_and_grad``; a kernel-mode miss excused only next
    to a quantizer code boundary (module docstring)."""
    near = _NearBoundary(monkeypatch)
    jm, jp, tm, tp = _models(variant, "float32", **MODES[mode])
    assert tm.cfg.remat == "full"
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 64)).astype(np.int32)}
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    want = _flat_ref(want)
    want_loss = float(want_loss)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tshd.tree_leaves(tp)]
    it = iter(leaves)
    live = tshd.tree_map(lambda _: next(it), tp)
    before = tops.crossbar_fwd.launches
    loss, metrics = tm.loss_fn(live, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert tops.crossbar_fwd.launches == before          # CPU: plain
    assert float(metrics["aux"]) == 0.0
    got = {_key(path): g.numpy() for (path, _), g in zip(_walk(live),
                                                         grads)}
    assert set(got) == set(want)
    ssd_leaves = {k.rsplit("/", 1)[-1] for k in got if "/ssd/" in k}
    assert {"a_log", "dt_bias", "d_skip", "conv_w", "conv_b"} <= ssd_leaves
    assert all(np.abs(got[k]).max() > 0 for k in got)
    loss = float(loss.detach())
    strict = abs(loss - want_loss) <= 1e-5 * abs(want_loss) and all(
        np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max()
        for k, w in want.items())
    if not strict:          # excused only next to a code boundary
        print(f"{variant} {mode}: off the fp32 bar with {near.count} "
              f"quantizer inputs near a code boundary")
        assert mode == "kernel" and near.count > 0
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        for k, w in want.items():
            nrel = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w),
                                                    1e-30)
            assert nrel <= 0.1, k


def test_chip_smoke_bf16_decode_figure_is_the_references():
    """``chip_smoke.py`` step 21 holds bf16 decode against bf16 prefill at
    full width within 2 d, d = ``SSM_BF16_DIST``: the reference's own
    bf16-vs-float32 relative distance on its reduced config, the largest
    over 8 batches of 4 x 24 tokens from numpy seeds 0-7.  The figure
    written in the script is the reference's, measured here; and the
    port's own bf16 decode against its bf16 prefill on the reduced config
    lies within 2 d."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fns = {d: _models("reduced", d)[0].prefill_fn
           for d in ("bfloat16", "float32")}
    jp = _models("reduced", "float32")[1]
    dists = []
    for seed in range(8):
        tok = jnp.asarray(_tokens(4, 24, seed))
        a, b = (np.asarray(fns[d](jp, {"tokens": tok}), np.float32)
                for d in ("bfloat16", "float32"))
        dists.append(np.linalg.norm(a - b) / np.linalg.norm(b))
    d = smoke.SSM_BF16_DIST
    assert f"{max(dists):.4g}" == f"{d:.4g}", (max(dists), d)
    _, _, tm, tp = _models("reduced", "bfloat16")
    tok = torch.from_numpy(_tokens(4, 24, 9))
    pre = tm.prefill_fn(tp, {"tokens": tok})
    cache, dec = tm.init_cache(4, 24), []
    for step in range(24):
        logits, cache = tm.decode_fn(tp, cache, {
            "tokens": tok[:, step:step + 1], "length": step})
        dec.append(logits)
    rel = float(torch.linalg.norm(torch.cat(dec, dim=1) - pre)
                / torch.linalg.norm(pre))
    print(f"d = {d}, the port's bf16 decode vs prefill {rel:.4f}")
    assert rel <= 2 * d


# ---------------------------------------------------------------------------
# the server and the CLIs
# ---------------------------------------------------------------------------

def test_batched_server_matches_the_reference():
    """``BatchedServer`` in float32 compute, 8-token prompts and 24 new
    tokens (31 decode steps, one padded slot): the same stats and tokens
    as the reference's server."""
    jm, jp, tm, tp = _models("reduced", "float32")
    prompts = PROMPTS[:3]
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=48)
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=48)
    want = js.generate(prompts, 24)
    got = ts.generate(prompts, 24)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.steps == 31 and ts.stats.tokens_out == 96
    assert got == want


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_serve_cli_on_cpu():
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "128 tokens in" in lines[-1] and "(39 decode steps)" in lines[-1]


def test_train_cli_on_cpu():
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
         "--seq", "64"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert p.returncode == 0, p.stderr
    last = p.stdout.strip().splitlines()[-1]
    assert last.startswith("final step 4: loss ") and "(first " in last
    first = float(last.split("(first ")[1].rstrip(")"))
    assert abs(first - math.log(512)) < 0.1


def test_build_model_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tcfg.get_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced"])
