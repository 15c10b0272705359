"""Port parity: the hybrid family (recurrentgemma-9b: RG-LRU ``rec``
blocks and windowed ``local`` attention with its rolling cache) of
``repro_torch`` against ``repro``'s, on the CPU.

The layers (``rglru_apply``'s prefill and decode step, the windowed
``chunked_attention``, the rolling cache) take the same numpy inputs on
both sides; the models take the reference's ``model.init(PRNGKey(0))``
parameters, carried across leaf for leaf by
``interop.lm_params_from_numpy``, at the reduced config (6 layers: two
(rec, rec, local) periods) and at an ``n_layers=8`` variant, whose
trailing (rec, rec) runs as the stack's suffix.

Tolerances, each with its reason:
- fp32 layers: 1e-5 absolute plus relative (sums in other orders; the
  scan associates as the reference's does, the conv sums its taps in the
  same order).
- bf16 windowed attention: one bf16 step plus 2^-7 max_j p_j |v_j| / l,
  the chunked bar of tests/test_torch_chunked_attention.py (p rounded to
  bf16 against the same running max on both sides; a last-bit difference
  of an fp32 score may move one rounding).
- model logits in float32 compute: 1e-4 absolute plus relative, the bar
  of tests/test_torch_lm.py, with a float32 cache; 1e-2 with a bf16 cache
  (it rounds each k and v to bf16, and where the two sides' fp32 values
  differ in the last bit next to a rounding boundary they land one bf16
  step apart: measured over 40 steps 4.0e-3, against 1.1e-5 with a
  float32 cache); 2e-2 with the int8 cache, as there.
- model logits in bf16 compute: in the Frobenius norm over all logits,
  the port within the reference's own bf16 noise, ||port - ref|| <=
  ||ref - ref in float32 compute||.  The recurrence carries a state with
  a close to 1, so one bf16 rounding that lands a step apart (the local
  layers' p, an fp32 last bit before a cast) moves every later logit of
  its row; both sides round at the same places (``gelu_tanh`` op for op
  in bf16, the scan's fused multiply-adds), yet measured at 64 tokens the
  port lies 0.019 / 0.022 (relative norm; 0.15 / 0.12 at most) from the
  reference, whose bf16 lies 0.027 / 0.032 from its fp32 (reduced / 8
  layers): a 1.4x margin.  A bar in absolute logits would be wrong.
- loss and gradients: the bars of tests/test_torch_train_step.py (fp32:
  the loss within 1e-5 relative, each leaf within 1e-4 of its largest).
"""
import dataclasses
import functools
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
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import rglru as jrg  # noqa: E402
from repro.dist.sharding import init_params as jinit  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import rglru as trg  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
TOL = 1e-5
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
VARIANTS = {"reduced": {}, "8 layers": {"n_layers": 8}}
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(4)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_and_param_count_equal_the_reference():
    for getter in ("get_config", "get_reduced_config"):
        jc = getattr(jcfg, getter)(ARCH)
        tc = getattr(tcfg, getter)(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.rglru()) == dataclasses.asdict(
            jc.rglru())
        ja = dataclasses.asdict(jc.attn(jc.window))
        assert dataclasses.asdict(tc.attn(tc.window)) == {
            f.name: ja[f.name] for f in dataclasses.fields(tc.attn())}
        assert tc.param_count() == jc.param_count()
        assert tc.layer_kinds() == jc.layer_kinds()
    assert tcfg.get_config(ARCH).param_count() == 10_444_771_328
    lay = tlm.stack_layout(tcfg.get_config(ARCH))
    assert (lay.pattern, lay.periods, lay.suffix) == (
        ("rec", "rec", "local"), 12, ("rec", "rec"))
    cfg = tcfg.get_reduced_config(ARCH, n_layers=8)
    assert cfg.param_count() == jcfg.get_reduced_config(
        ARCH, n_layers=8).param_count()
    assert tlm.stack_layout(cfg).suffix == ("rec", "rec")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

RG = dict(d_model=12, d_rnn=16)


def _rglru_params(seed=6):
    jp = jinit(jax.random.PRNGKey(seed), jrg.rglru_spec(jrg.RGLRUConfig(**RG)))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


@pytest.mark.parametrize("L", [1, 2, 33, 100])
def test_associative_scan_matches_jax(L):
    rng = np.random.default_rng(L)
    a = rng.uniform(0.5, 1.0, (2, L, 5)).astype(np.float32)
    b = rng.standard_normal((2, L, 5)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = trg.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    # and the scan is the recurrence h_t = a_t h_{t-1} + b_t
    h, seq = np.zeros((2, 5), np.float32), []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(_f32(got[1]), np.stack(seq, 1), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_prefill_matches_the_reference(dtype):
    jp, tp = _rglru_params()
    x = np.random.default_rng(7).standard_normal((2, 33, 12)).astype(
        np.float32) * 0.5
    cfg = jrg.RGLRUConfig(**RG)
    want, _ = jrg.rglru_apply(jp, jnp.asarray(x), cfg,
                              compute_dtype=getattr(jnp, dtype))
    got, cache = trg.rglru_apply(tp, torch.from_numpy(x),
                                 trg.RGLRUConfig(**RG),
                                 compute_dtype=getattr(torch, dtype))
    assert cache is None and got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_rglru_decode_after_prefill_matches_the_reference():
    """Prefill 32 tokens into a cache, then decode the 33rd (the reference
    test tests/test_layers.py::test_rglru_assoc_scan_matches_sequential),
    on both sides; the port's step also equals its own 33-token prefill's
    last row and writes the cache in place."""
    jp, tp = _rglru_params()
    x = np.random.default_rng(7).standard_normal((2, 33, 12)).astype(
        np.float32) * 0.5
    jc, tc = jrg.RGLRUConfig(**RG), trg.RGLRUConfig(**RG)
    f32 = dict(compute_dtype=jnp.float32)
    jcache = jrg.init_rglru_cache(jc, 2)
    _, jcache = jrg.rglru_apply(jp, jnp.asarray(x[:, :32]), jc,
                                cache=jcache, **f32)
    want, jcache = jrg.rglru_apply(jp, jnp.asarray(x[:, 32:]), jc,
                                   cache=jcache, **f32)
    tcache = trg.init_rglru_cache(tc, 2, device="cpu")
    buffers = [t.data_ptr() for t in tcache.values()]
    f32 = dict(compute_dtype=torch.float32)
    _, out = trg.rglru_apply(tp, torch.from_numpy(x[:, :32]), tc,
                             cache=tcache, **f32)
    assert out is tcache
    got, out = trg.rglru_apply(tp, torch.from_numpy(x[:, 32:]), tc,
                               cache=tcache, **f32)
    assert out is tcache and [t.data_ptr() for t in out.values()] == buffers
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(_f32(tcache[key]), _f32(jcache[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    assert int(tcache["length"]) == int(jcache["length"]) == 33
    full, _ = trg.rglru_apply(tp, torch.from_numpy(x), tc, **f32)
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(full[:, 32]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gelu_is_the_reference_gelu(dtype):
    """``mlp.ACTS["gelu"]`` evaluates ``jax.nn.gelu`` op for op: bit for
    bit in bf16, where every op rounds and the constants are rounded to
    bf16 (``F.gelu`` rounds once and differs in ~40 % of outputs), and
    within 1e-6 in fp32 (XLA's tanh differs from torch's in the last
    bits; measured 5.8e-7)."""
    from repro_torch.layers import mlp as tmlp
    x = np.random.default_rng(0).standard_normal(20000).astype(
        np.float32) * 3
    want = _f32(jax.jit(jax.nn.gelu)(jnp.asarray(x).astype(
        getattr(jnp, dtype))))
    got = _f32(tmlp.ACTS["gelu"](torch.from_numpy(x).to(
        getattr(torch, dtype))))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rglru_init_draws_the_reference_distribution():
    """``lam`` puts a = exp(-c softplus(lam)) in [0.9, 0.999] and
    ``conv_w`` has std 1/sqrt(d_conv), as the reference's initializers."""
    cfg = trg.RGLRUConfig(d_model=64, d_rnn=4096)
    p = tshd.init_params(torch.Generator().manual_seed(0),
                         trg.rglru_spec(cfg))
    a = torch.exp(-trg.RGLRU_C * torch.nn.functional.softplus(p["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert abs(float(p["conv_w"].std()) - 0.5) < 0.02
    assert torch.equal(p["conv_b"], torch.zeros(4096))


# ---------------------------------------------------------------------------
# windowed attention
# ---------------------------------------------------------------------------

J_CHUNKED = jax.jit(jattn.chunked_attention, static_argnames=(
    "scale", "causal", "window", "q_chunk", "kv_chunk",
    "skip_masked_blocks"))


def _qkv(B, S, H, K, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, S, H, hd), np.float32),
              rng.standard_normal((B, S, K, hd), np.float32),
              rng.standard_normal((B, S, K, hd), np.float32))
    jd = getattr(jnp, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def max_weighted_term(q, k, v, scale, window) -> np.ndarray:
    """max_j p_j |v_j| / l of each output in fp32, p the plain causal
    softmax banded to ``window``."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    qi, ki = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill((ki > qi) | (ki <= qi - window), fak.NEG_INF)
    p = torch.softmax(s, dim=-1)
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    t = (p[..., None] * va).amax(dim=-2)
    return _f32(t.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd))


def _assert_attention_close(got, want, dtype, q, k, v, scale, window, what):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL,
                                   rtol=TOL, err_msg=str(what))
        return
    g, w = _f32(got), _f32(want)
    bar = (bf16_step(np.maximum(np.abs(g), np.abs(w))) + 1e-6
           + 2.0 ** -7 * max_weighted_term(q, k, v, scale, window))
    assert (np.abs(g - w) <= bar).all(), (what, float(np.abs(g - w).max()))


# (B, S, H, K, hd, window, chunk, skip): the reference test's two window
# cases (tests/test_layers.py:37-39), hd 256, a window >= S, window 1, and
# a ragged S (one 200-row chunk on the reference's side)
WINDOW_CASES = [
    (2, 128, 4, 2, 16, 32, 32, False),
    (2, 128, 4, 2, 16, 32, 32, True),
    (1, 128, 4, 1, 256, 48, 64, False),
    (2, 96, 4, 2, 16, 96, 32, False),
    (2, 96, 4, 2, 16, 500, 32, False),
    (2, 64, 4, 2, 16, 1, 32, False),
    (1, 200, 4, 2, 32, 50, 512, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_chunked_attention_matches_the_reference(case, dtype):
    B, S, H, K, hd, window, chunk, skip = case
    (jq, jk, jv), (q, k, v) = _qkv(B, S, H, K, hd, S + window, dtype)
    kw = dict(scale=hd ** -0.5, causal=True, window=window, q_chunk=chunk,
              kv_chunk=chunk)
    want = J_CHUNKED(jq, jk, jv, **kw, skip_masked_blocks=skip)
    got = tattn.chunked_attention(q, k, v, **kw, skip_masked_blocks=skip)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    _assert_attention_close(got, want, dtype, q, k, v, hd ** -0.5, window,
                            case)
    # skip_masked_blocks is a schedule flag only
    assert torch.equal(got, tattn.chunked_attention(
        q, k, v, **kw, skip_masked_blocks=not skip))


def test_ragged_chunks_and_a_window_at_least_s():
    """The plain version's ragged last chunk (S = 200 at 64-key chunks)
    against the reference's one 200-row chunk in fp32 (rounding p is a
    no-op there), and a window of S or more equal bit for bit to no
    window."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 200, 4, 2, 32, 3, "float32")
    want = J_CHUNKED(jq, jk, jv, scale=0.25, causal=True, window=50,
                     q_chunk=200, kv_chunk=200)
    got = fak.chunked_attention_plain(q, k, v, scale=0.25, q_chunk=64,
                                      kv_chunk=64, window=50)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        causal = fak.chunked_attention_plain(qd, kd, vd, scale=0.25,
                                             q_chunk=64, kv_chunk=64)
        for window in (200, 201, 10 ** 6):
            assert torch.equal(causal, fak.chunked_attention_plain(
                qd, kd, vd, scale=0.25, q_chunk=64, kv_chunk=64,
                window=window))


def test_window_refusals():
    x = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="semantics='chunked'"):
        tops.flash_attention(x, x, x, scale=0.25, window=4)
    for bad in (0, -1, 2.5, True):
        with pytest.raises(ValueError, match="positive int"):
            tops.flash_attention(x, x, x, scale=0.25, semantics="chunked",
                                 window=bad)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        tops.flash_attention(x, x[:, :8], x[:, :8], scale=0.25,
                             semantics="chunked", window=4)
    # on a tensor off the CPU a window and hd 256 go to the kernel, which
    # raises here (no card): nothing falls back to the plain version
    wide = torch.zeros(1, 16, 2, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        fak.flash_attention_kernel(wide, wide, wide, scale=1 / 16,
                                   semantics="chunked", window=4)
    assert 256 in fak.TC_HEAD_DIMS and fak.MAX_HD == 256
    with pytest.raises(ValueError, match="head widths"):
        tops.flash_attention(torch.zeros(1, 4, 2, 257),
                             torch.zeros(1, 4, 2, 257),
                             torch.zeros(1, 4, 2, 257), scale=0.1)


def test_rolling_cache_window_semantics():
    """The rolling window cache keeps exactly the last ``window``
    positions (tests/test_layers.py::test_rolling_cache_window_semantics),
    in place, as the reference's."""
    jc = jattn.AttnConfig(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
                          window=4)
    tc = tattn.AttnConfig(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
                          window=4)
    jcache = jattn.init_self_cache(jc, batch=1, max_len=100)
    tcache = tattn.init_self_cache(tc, batch=1, max_len=100, device="cpu")
    assert tcache["k"].shape[1] == 4 and tcache["pos"].shape == (4,)
    assert tattn.init_self_cache(tc, 1, 3, device="cpu")["k"].shape[1] == 3
    for t in range(7):
        jk = jnp.full((1, 1, 1, 4), float(t))
        jcache = jattn._cache_append(jcache, jk, jk)
        tk = torch.full((1, 1, 1, 4), float(t))
        assert tattn._cache_append(tcache, tk, tk) is tcache
    assert sorted(tcache["pos"].tolist()) == [3, 4, 5, 6]
    for key in ("k", "v", "pos", "length"):
        np.testing.assert_array_equal(_f32(tcache[key]), _f32(jcache[key]))


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_local_attention_decode_past_the_window(cache_dtype):
    """``attention_apply`` with a window: 20 decode steps over a rolling
    cache of 8 slots, against the reference step by step (float32
    compute), and the port's decode against its own windowed prefill."""
    acfg = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, window=8,
                q_chunk=16, kv_chunk=16)
    jc, tc = jattn.AttnConfig(**acfg), tattn.AttnConfig(**acfg)
    jp = jinit(jax.random.PRNGKey(3), jattn.attention_spec(jc))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 20, 64)).astype(
        np.float32)
    jcache = jattn.init_self_cache(jc, 2, 32, getattr(jnp, cache_dtype))
    tcache = tattn.init_self_cache(tc, 2, 32, getattr(torch, cache_dtype),
                                   "cpu")
    assert tcache["k"].shape[1] == 8
    tol = 1e-4 if cache_dtype == "bfloat16" else 2e-2
    outs = []
    for t in range(20):
        pos = np.full((2, 1), t, np.int64)
        want, jcache = jattn.attention_apply(
            jp, jnp.asarray(x[:, t:t + 1]), jc, positions=jnp.asarray(pos),
            cache=jcache, compute_dtype=jnp.float32)
        got, tcache = tattn.attention_apply(
            tp, torch.from_numpy(x[:, t:t + 1]), tc,
            positions=torch.from_numpy(pos), cache=tcache,
            compute_dtype=torch.float32)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol, err_msg=str(t))
        outs.append(got)
    np.testing.assert_array_equal(_f32(tcache["pos"]), _f32(jcache["pos"]))
    if cache_dtype == "bfloat16":
        pre, _ = tattn.attention_apply(
            tp, torch.from_numpy(x), tc,
            positions=torch.arange(20).expand(2, 20),
            compute_dtype=torch.float32)
        # the cache rounds k and v to bf16; the prefill keeps them fp32
        torch.testing.assert_close(torch.cat(outs, 1), pre, atol=2e-2,
                                   rtol=2e-2)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(variant, compute_dtype):
    over = dict(VARIANTS[variant], compute_dtype=compute_dtype)
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
    # the port's own spec has the reference's shapes, leaf for leaf (the
    # abstract tree flattened in the reference's key order)
    spec = jax.tree.leaves(tm.abstract_params())
    assert [tuple(s.shape) for s in spec] == [a.shape for _, a in jleaves]
    mix = tp["stack"]["b0_rec"]["mix"]
    assert set(mix) == {"in_proj", "gate_proj", "conv_w", "conv_b", "w_a",
                        "w_x", "lam", "out_proj"}
    assert mix["lam"].shape == (2, 64) and mix["conv_w"].shape == (2, 4, 64)
    assert len(tp["suffix"]) == (2 if variant == "8 layers" else 0)
    back = interop.lm_params_to_numpy(tp)
    for (_, a), b in zip(jleaves, tshd.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_prefill_matches_the_reference(models):
    variant, dtype, jm, jp, tm, tp = models
    tok = _tokens(2, 64)            # past the reduced config's window of 32
    want = jm.prefill_fn(jp, {"tokens": jnp.asarray(tok)})
    before = tops.flash_attention.launches
    got = tm.prefill_fn(tp, {"tokens": torch.from_numpy(tok)})
    assert tops.flash_attention.launches == before     # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (2, 64, 512)
    if dtype == "float32":
        tol = LOGIT_TOL[dtype]
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)
    else:
        jm32, jp32, _, _ = _models(variant, "float32")
        want32 = jm32.prefill_fn(jp32, {"tokens": jnp.asarray(tok)})
        _assert_within_bf16_noise(got, want, want32)


def _assert_within_bf16_noise(got, want, want32):
    """||got - want|| <= ||want - want32|| in the Frobenius norm (module
    docstring)."""
    got, want, want32 = _f32(got), _f32(want), _f32(want32)
    assert np.isfinite(got).all()
    dist, noise = (np.linalg.norm(got - want),
                   np.linalg.norm(want - want32))
    assert dist <= noise, (dist / np.linalg.norm(want),
                           noise / np.linalg.norm(want))


def _cache_tol(dtype, cache_dtype):
    """The logit bar of a decode with ``cache_dtype`` (module docstring)."""
    return {"float32": LOGIT_TOL[dtype], "bfloat16": LOGIT_TOL["bfloat16"],
            "int8": 2e-2}[cache_dtype]


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_decode_past_the_window_matches_the_reference(models, cache_dtype):
    """40 decode steps over rolling caches of 32 slots (the reduced
    window), the rec blocks' fp32 conv and state beside them; the cache
    is written in place.  float32 compute is held step by step, bf16
    compute over the 40 steps' logits against the reference's own bf16
    noise (module docstring)."""
    variant, dtype, jm, jp, tm, tp = models
    jd, td = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    tok = _tokens(2, 40, 1)

    def ref_decode(jm, jp):
        jc, out = jm.init_cache(2, 48, jd), []
        for step in range(40):
            logits, jc = jm.decode_fn(jp, jc, {
                "tokens": jnp.asarray(tok[:, step:step + 1]),
                "length": jnp.int32(step)})
            out.append(logits)
        return jnp.concatenate(out, axis=1), jc

    want, jc = ref_decode(jm, jp)
    tc = tm.init_cache(2, 48, td)
    assert tc["stack"]["b2_local"]["k"].shape == (2, 2, 32, 1, 16)
    assert tc["stack"]["b0_rec"]["state"].dtype == torch.float32
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
    for key in ("pos", "length"):
        np.testing.assert_array_equal(_f32(tc["stack"]["b2_local"][key]),
                                      _f32(jc["stack"]["b2_local"][key]))
    if dtype == "bfloat16":
        jm32, jp32, _, _ = _models(variant, "float32")
        _assert_within_bf16_noise(got, want, ref_decode(jm32, jp32)[0])
        return
    tol = _cache_tol(dtype, cache_dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    for j, t in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        if t.dtype == torch.float32:            # conv windows and states
            np.testing.assert_allclose(_f32(t), np.asarray(j, np.float32),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_the_reference(variant):
    """float32 compute: the loss within 1e-5 relative and every gradient
    leaf within 1e-4 of its largest (the scan's and the conv's gradients
    included), through remat "full"."""
    jm, jp, tm, tp = _models(variant, "float32")
    assert tm.cfg.remat == "full"
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 64)).astype(np.int32)}
    (want_loss, _), want = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tshd.tree_leaves(tp)]
    it = iter(leaves)
    live = tshd.tree_map(lambda _: next(it), tp)
    loss, metrics = tm.loss_fn(live, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(metrics["aux"]) == 0.0
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(grads)
    for (path, w), g in zip(flat, grads):
        w = np.asarray(w, np.float32)
        assert np.abs(_f32(g) - w).max() <= 1e-4 * np.abs(w).max(), path


# ---------------------------------------------------------------------------
# the server and the CLI
# ---------------------------------------------------------------------------

def _excused(jm, jp, prompt, got, want, tol):
    """Positions of one slot whose tokens differ: the first difference
    must be a near-tie of the reference's logits (top-2 gap <= tol); it
    and the slot's later tokens are excused.  Returns how many."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            seq = jnp.asarray([prompt + want[:i]], jnp.int32)
            row = np.sort(np.asarray(jm.prefill_fn(jp, {"tokens": seq}),
                                     np.float32)[0, -1])
            assert row[-1] - row[-2] <= tol, (i, row[-1] - row[-2])
            return len(got) - i
    return 0


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batched_server_matches_the_reference(variant, cache_dtype):
    """``BatchedServer`` past the window, float32 compute: 8-token prompts
    and 30 new tokens (37 decode steps over rolling caches of 32 slots).
    (In bf16 compute a token may differ away from a near-tie: module
    docstring.)"""
    dtype = "float32"
    jm, jp, tm, tp = _models(variant, dtype)
    prompts = PROMPTS[:3]                     # one padded slot
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=48,
                              cache_dtype=getattr(jnp, cache_dtype))
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=48,
                              cache_dtype=getattr(torch, cache_dtype))
    want = js.generate(prompts, 30)
    got = ts.generate(prompts, 30)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.steps == 37 and ts.stats.tokens_out == 120
    assert int(ts.cache["stack"]["b2_local"]["length"][0]) == 37
    tol = _cache_tol(dtype, cache_dtype)
    excused = sum(_excused(jm, jp, p, g, w, tol)
                  for p, g, w in zip(prompts, got, want))
    assert excused <= 30, (got, want)   # at most one slot left a near-tie
    print(f"{dtype} / {cache_dtype} cache: {excused} of 90 tokens excused")


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--max-new", "40"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "160 tokens in" in lines[-1] and "(47 decode steps)" in lines[-1]


def test_build_model_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tcfg.get_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced"])
