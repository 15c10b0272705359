"""Port parity: the LM layers of ``repro_torch.layers`` against
``repro.layers`` on the same numpy inputs and the reference's initialised
parameters (carried across by ``repro_torch.interop``).

Tolerances, each with its reason:
- fp32 arithmetic: 1e-5 absolute plus 1e-5 relative (the sides sum in
  different orders); rope in fp32: 1e-6 (the angles agree exactly, cos and
  sin differ by an ulp between the two libms at positions up to 2048 and
  theta 1e6).
- a single bf16 rounding (a bf16 product, rope in bf16, the cache's
  codes): one bf16 step, |a - b| <= bf16 spacing at max(|a|, |b|) + 1e-6.
- layers that chain several bf16 roundings (MLP, attention): 2e-2
  absolute plus relative, about four bf16 steps at |x| ~ 1.
- int8 KV codes: equal, except a code may differ by one where x / scale
  lies within 1e-2 of a half-integer (the bf16 quotient rounds there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import sharding as jshd  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import embedding as jemb  # noqa: E402
from repro.layers import linear as jlin  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import rope as jrope  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import embedding as temb  # noqa: E402
from repro_torch.layers import linear as tlin  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.layers import rope as trope  # noqa: E402

TOL = 1e-5
CHAIN_TOL = 2e-2
# the reference's layers, jitted: one compile per shape instead of one per
# operation (config objects and dtypes are static).  Rope stays unjitted:
# jitted, the reference's own rope at positions up to 2048 moves by up to
# 6.1e-5 from its op-by-op result, which uses libm's cos and sin as the
# port does.
J = {
    "rmsnorm": jax.jit(jnorms.rmsnorm_apply),
    "layernorm": jax.jit(jnorms.layernorm_apply),
    "embed": jax.jit(jemb.embed_apply, static_argnums=(2,)),
    "head": jax.jit(jemb.lm_head_apply,
                    static_argnames=("compute_dtype", "valid_vocab")),
    "dense": jax.jit(jlin.dense_apply,
                     static_argnames=("compute_dtype", "xbar")),
    "mlp": jax.jit(jmlp.mlp_apply, static_argnames=("act", "compute_dtype")),
    "decode": jax.jit(jattn.decode_attention, static_argnames=("scale",)),
    "append": jax.jit(jattn._cache_append),
    "attn": jax.jit(jattn.attention_apply,
                    static_argnames=("cfg", "compute_dtype")),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a.copy()).to(td)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _params(spec, seed=0):
    """Reference-initialised parameters: (jax tree, port tree on CPU)."""
    jp = jshd.init_params(jax.random.PRNGKey(seed), spec)
    return jp, interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def assert_one_bf16_step(got, want, what=""):
    got, want = _f32(got), _f32(want)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    bar = np.ldexp(np.float32(1.0), e - 8) + 1e-6
    err = np.abs(got - want)
    assert (err <= bar).all(), (what, float(err.max()))


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=str(what))


# ---------------------------------------------------------------------------
# norms, rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind, dtype):
    x = _randn((3, 5, 48), 0, 2.0)
    scale = _randn((48,), 1) * 0.1 + 1.0
    bias = _randn((48,), 2) * 0.1
    params = {"scale": scale} if kind == "rmsnorm" else \
        {"scale": scale, "bias": bias}
    jx, tx = _pair(x, dtype)
    jfn = J[kind]
    tfn = getattr(tnorms, f"{kind}_apply")
    want = jfn({k: jnp.asarray(v) for k, v in params.items()}, jx)
    got = tfn({k: torch.from_numpy(v) for k, v in params.items()}, tx)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        assert_close(got, want, TOL, kind)
    else:
        assert_one_bf16_step(got, want, kind)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_to_2048_at_theta_1e6(dtype):
    pos = np.tile(np.arange(2048), (2, 1))
    x = _randn((2, 2048, 4, 64), 3)
    jx, tx = _pair(x, dtype)
    want = jrope.apply_rope(jx, jnp.asarray(pos), theta=1e6)
    got = trope.apply_rope(tx, torch.from_numpy(pos), theta=1e6)
    # the angles bit for bit at every head_dim and theta the configs use
    for hd in (64, 128, 256):
        for theta in (1e4, 1e6, 5e6):
            np.testing.assert_array_equal(
                trope._rope_angles(torch.from_numpy(pos), hd, theta).numpy(),
                np.asarray(jrope._rope_angles(jnp.asarray(pos), hd, theta)),
                err_msg=f"hd {hd}, theta {theta}")
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        assert_close(got, want, 1e-6)
    else:
        assert_one_bf16_step(got, want)


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------

def test_embedding_and_tied_head_with_pad_mask():
    vocab, padded, d = 300, 512, 32
    jp, tp = _params(jemb.embedding_spec(padded, d), 4)
    tokens = np.random.default_rng(5).integers(0, vocab, (2, 7))
    for dtype in DTYPES:
        jd, td = DTYPES[dtype]
        want = J["embed"](jp, jnp.asarray(tokens), jd)
        got = temb.embed_apply(tp, torch.from_numpy(tokens), td)
        np.testing.assert_array_equal(_f32(got), _f32(want))
        x = _randn((2, 7, d), 6)
        jx, tx = _pair(x, dtype)
        want = J["head"]({}, jx, tied_table=jp["table"],
                         compute_dtype=jd, valid_vocab=vocab)
        got = temb.lm_head_apply({}, tx, tied_table=tp["table"],
                                 compute_dtype=td, valid_vocab=vocab)
        assert got.dtype == torch.float32 and got.shape == (2, 7, padded)
        assert (got[..., vocab:] == -1e30).all()
        if dtype == "float32":
            assert_close(got, want, TOL)
        else:
            assert_one_bf16_step(got, want)
    labels = np.random.default_rng(7).integers(0, vocab, (2, 7))
    logits = _randn((2, 7, padded), 8)
    assert_close(temb.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels)),
                 jemb.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)),
                 TOL)


def test_untied_head_matches():
    jp, tp = _params(jemb.lm_head_spec(32, 256), 9)
    x = _randn((3, 32), 10)
    assert_close(temb.lm_head_apply(tp, torch.from_numpy(x),
                                    compute_dtype=torch.float32,
                                    valid_vocab=200),
                 jemb.lm_head_apply(jp, jnp.asarray(x),
                                    compute_dtype=jnp.float32,
                                    valid_vocab=200), TOL)


# ---------------------------------------------------------------------------
# projections: the three spec layouts, qmatmul's gradient
# ---------------------------------------------------------------------------

MODES = {
    "standard": None,
    "paired": dict(paired=True),
    "unpaired": dict(paired=False),
    "kernel": dict(paired=True, use_kernel=True),
}


def _xbar(mode, lib):
    kw = MODES[mode]
    return None if kw is None else lib.XbarMode(**kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_dense_apply_all_modes(mode):
    jspec = jlin.dense_spec(24, 20, ("fsdp", "ff"), bias=True,
                            xbar=_xbar(mode, jlin))
    tspec = tlin.dense_spec(24, 20, ("fsdp", "ff"), bias=True,
                            xbar=_xbar(mode, tlin))
    assert jax.tree.map(lambda s: s.shape, jspec,
                        is_leaf=lambda s: isinstance(s, jshd.ParamSpec)) == \
        tshd.tree_map(lambda s: s.shape, tspec)
    jp, tp = _params(jspec, 11)
    tp["b"] = torch.from_numpy(_randn((20,), 12))    # a nonzero bias
    jp["b"] = jnp.asarray(tp["b"].numpy())
    x = _randn((5, 24), 13)
    want = J["dense"](jp, jnp.asarray(x), compute_dtype=jnp.float32,
                      xbar=_xbar(mode, jlin))
    got = tlin.dense_apply(tp, torch.from_numpy(x),
                           compute_dtype=torch.float32,
                           xbar=_xbar(mode, tlin))
    assert_close(got, want, TOL, mode)
    if mode == "standard":
        jx, tx = _pair(x, "bfloat16")
        got = tlin.dense_apply(tp, tx)
        assert got.dtype == torch.bfloat16
        assert_one_bf16_step(got, J["dense"](jp, jx))


def test_port_draws_the_spec_layouts():
    """The port's own initializers: shapes, clipping and the pair's sum."""
    spec = tlin.dense_spec(400, 100, ("fsdp", "ff"), bias=True,
                           xbar=tlin.XbarMode(w_max=0.1))
    p = tshd.init_params(torch.Generator().manual_seed(0), spec)
    assert set(p) == {"g_plus", "g_minus", "b"}
    assert (p["g_plus"] >= 0).all() and (p["g_minus"] <= 0.1).all()
    assert not torch.equal(p["g_plus"] + p["g_minus"],
                           torch.full_like(p["g_plus"], 0.1))
    w = tshd.init_params(torch.Generator().manual_seed(0),
                         tlin.dense_spec(400, 100, ("fsdp", "ff")))["w"]
    assert abs(float(w.std()) - 400 ** -0.5) < 2e-3


def test_qmatmul_gradient_matches_jax_grad():
    x = _randn((6, 16), 14)
    w = _randn((16, 12), 15, 0.3)
    t = _randn((6, 12), 16)

    def jloss(x, w):
        return jnp.sum((jlin.qmatmul(x, w, 8) - t) ** 2)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    torch.sum((tlin.qmatmul(tx, tw, 8) - torch.from_numpy(t)) ** 2).backward()
    assert_close(tx.grad, jdx, TOL)
    assert_close(tw.grad, jdw, TOL)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False), ("gelu", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(act, gated, dtype):
    jp, tp = _params(jmlp.mlp_spec(32, 64, gated=gated), 17)
    x = _randn((2, 5, 32), 18)
    jx, tx = _pair(x, dtype)
    jd, td = DTYPES[dtype]
    want = J["mlp"](jp, jx, act=act, compute_dtype=jd)
    got = tmlp.mlp_apply(tp, tx, act=act, compute_dtype=td)
    assert got.dtype == td
    assert_close(got, want, TOL if dtype == "float32" else CHAIN_TOL)


# ---------------------------------------------------------------------------
# attention: decode over a cache, the cache itself, the whole layer
# ---------------------------------------------------------------------------

ACFG = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
            rope_theta=1e6)
JACFG = dict(ACFG, q_chunk=32, kv_chunk=32)     # the reference's tiling


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    q = _randn((2, 1, 4, 16), 19)
    kc = _randn((2, 24, 2, 16), 20)
    vc = _randn((2, 24, 2, 16), 21)
    valid = np.arange(24)[None, :] < np.array([[9], [24]])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kc, vc))
    want = J["decode"](jq, jk, jv, jnp.asarray(valid), scale=0.25)
    got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(valid),
                                 scale=0.25)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        assert_close(got, want, TOL)
    else:
        assert_one_bf16_step(got, want)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_cache_append_in_place(cache_dtype):
    cfg_j = jattn.AttnConfig(**JACFG)
    cfg_t = tattn.AttnConfig(**ACFG)
    jd = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}[cache_dtype]
    td = getattr(torch, cache_dtype)
    jc = jattn.init_self_cache(cfg_j, 2, 6, jd)
    tc = tattn.init_self_cache(cfg_t, 2, 6, td, "cpu")
    assert set(jc) == set(tc)
    buffers = {k: v.data_ptr() for k, v in tc.items()}
    flips = 0
    for step in range(8):                          # wraps past size 6
        k = _randn((2, 1, 2, 16), 30 + step)
        v = _randn((2, 1, 2, 16), 40 + step, 0.01)
        jk, tk = _pair(k, "bfloat16")
        jv, tv = _pair(v, "bfloat16")
        jc = J["append"](jc, jk, jv)
        out = tattn._cache_append(tc, tk, tv)
        assert out is tc
        for name in ("pos", "length", "k_scale", "v_scale"):
            if name in jc:
                np.testing.assert_array_equal(_f32(tc[name]),
                                              _f32(jc[name]), name)
        for name in ("k", "v"):
            a, b = _f32(tc[name]), _f32(jc[name])
            if cache_dtype == "bfloat16":
                np.testing.assert_array_equal(a, b)
                continue
            scale = _f32(tc[f"{name}_scale"])[..., None]
            src = _f32(tk if name == "k" else tv)
            off = a != b
            flips += int(off.sum())
            assert (np.abs(a - b) <= 1).all()
            slot = step % 6
            frac = np.abs(src[:, 0] / np.where(scale[:, slot] == 0, 1,
                                               scale[:, slot]))
            near_half = np.abs(frac - np.floor(frac) - 0.5) < 1e-2
            assert (~off[:, slot] | near_half).all()
    assert {k: v.data_ptr() for k, v in tc.items()} == buffers
    assert flips <= 4


def _attn_params(seed=22):
    return _params(jattn.attention_spec(jattn.AttnConfig(**JACFG)), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_prefill(dtype):
    jp, tp = _attn_params()
    x = _randn((2, 64, 64), 23)
    jx, tx = _pair(x, dtype)
    jd, td = DTYPES[dtype]
    pos = np.tile(np.arange(64), (2, 1))
    want, _ = J["attn"](jp, jx, cfg=jattn.AttnConfig(**JACFG),
                        positions=jnp.asarray(pos), compute_dtype=jd)
    got, cache = tattn.attention_apply(
        tp, tx, tattn.AttnConfig(**JACFG), positions=torch.from_numpy(pos),
        compute_dtype=td)
    assert cache is None and got.dtype == td
    assert_close(got, want, TOL if dtype == "float32" else CHAIN_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_attention_apply_decode(cache_dtype):
    jp, tp = _attn_params(24)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "int8": jnp.int8}[cache_dtype]
    jc = jattn.init_self_cache(jattn.AttnConfig(**JACFG), 2, 16, jd)
    tc = tattn.init_self_cache(tattn.AttnConfig(**ACFG), 2, 16,
                               getattr(torch, cache_dtype), "cpu")
    compute = (jnp.float32, torch.float32) if cache_dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = TOL if cache_dtype == "float32" else CHAIN_TOL
    for step in range(10):
        x = _randn((2, 1, 64), 50 + step)
        jx, tx = _pair(x, "float32")
        pos = np.full((2, 1), step)
        want, jc = J["attn"](jp, jx, cfg=jattn.AttnConfig(**JACFG),
                             positions=jnp.asarray(pos), cache=jc,
                             compute_dtype=compute[0])
        got, tc = tattn.attention_apply(
            tp, tx, tattn.AttnConfig(**ACFG),
            positions=torch.from_numpy(pos), cache=tc,
            compute_dtype=compute[1])
        assert_close(got, want, tol, (cache_dtype, step))
    assert int(tc["length"]) == 10


def test_unported_attention_raises():
    """Windows (tests/test_torch_hybrid.py), bidirectional prefill,
    cross-attention over a cache (tests/test_torch_encdec.py) and M-RoPE
    (tests/test_torch_vlm.py) are ported and match the reference; M-RoPE
    sections that do not sum to head_dim / 2 fail on both sides."""
    jp, tp = _attn_params()
    x = _randn((1, 4, 64), 30)
    jx, tx = _pair(x, "float32")
    pos = np.zeros((1, 4), np.int64)
    kv = _randn((1, 6, 2, 16), 31)
    assert tattn.attention_apply(tp, tx, tattn.AttnConfig(**ACFG, window=8),
                                 positions=torch.from_numpy(pos)
                                 )[0].shape == tx.shape
    for causal, jkw, tkw in (
            (False, {}, {}),                                # bidirectional
            (True, {"cache": {"k": jnp.asarray(kv), "v": jnp.asarray(kv)}},
             {"cache": {"k": torch.from_numpy(kv),         # cross-attention
                        "v": torch.from_numpy(kv)}})):
        want, _ = J["attn"](jp, jx, cfg=jattn.AttnConfig(**JACFG,
                                                         causal=causal),
                            positions=jnp.asarray(pos),
                            compute_dtype=jnp.float32, **jkw)
        got, _ = tattn.attention_apply(
            tp, tx, tattn.AttnConfig(**ACFG, causal=causal),
            positions=torch.from_numpy(pos), compute_dtype=torch.float32,
            **tkw)
        assert_close(got, want, TOL, (causal, list(tkw)))
    pos3 = np.random.default_rng(32).integers(0, 64, (1, 4, 3))
    want, _ = J["attn"](jp, jx, cfg=jattn.AttnConfig(
        **JACFG, mrope_sections=(2, 3, 3)), positions=jnp.asarray(pos3),
        compute_dtype=jnp.float32)
    got, _ = tattn.attention_apply(tp, tx, tattn.AttnConfig(
        **ACFG, mrope_sections=(2, 3, 3)), positions=torch.from_numpy(pos3),
        compute_dtype=torch.float32)
    assert_close(got, want, TOL, "mrope")
    with pytest.raises(AssertionError):
        J["attn"](jp, jx, cfg=jattn.AttnConfig(
            **JACFG, mrope_sections=(2, 3, 2)), positions=jnp.asarray(pos3),
            compute_dtype=jnp.float32)
    with pytest.raises(AssertionError):
        tattn.attention_apply(tp, tx, tattn.AttnConfig(
            **ACFG, mrope_sections=(2, 3, 2)),
            positions=torch.from_numpy(pos3))
