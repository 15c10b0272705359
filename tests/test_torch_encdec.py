"""Port parity: the encoder-decoder family (seamless-m4t-medium: the
bidirectional encoder, the decoder's causal self-attention and its
cross-attention over the encoder's output, the cross cache) of
``repro_torch`` against ``repro``'s, on the CPU.

The models take the reference's ``model.init(PRNGKey(0))`` parameters,
carried across by ``interop.lm_params_from_numpy``, at the reduced config
(d 64, 2 + 2 layers, 4 heads of 16, vocab 512, chunks of 32); the inputs
are numpy draws from fixed seeds: 96 source frames and 64 target tokens,
so query and key lengths differ in the cross-attention (the reference
asserts that its chunks divide both).  The layers (``layernorm_apply``,
the non-gated relu ``mlp_apply``, ``attention_apply`` bidirectional and
cross, ``chunked_attention`` non-causal at Sq != Skv) take the
reference's ``init_params`` draws the same way.

Tolerances, each with its reason:
- float32 compute: 1e-5 absolute plus relative for the layers, 1e-4 for
  the model's outputs (encoder states, cross k/v, logits, caches): fp32
  sums in other orders through four layers, the bars of
  tests/test_torch_lm.py.
- bf16 compute: the layers within 2e-2 absolute plus relative (the
  chained bf16 bar of tests/test_torch_lm_layers.py), ``chunked_attention``
  within one bf16 step plus 2^-7 max_j p_j |v_j| / l
  (tests/test_torch_chunked_attention.py's bar); the model's outputs in
  the Frobenius norm within the reference's own bf16 noise, ||port - ref||
  <= ||ref - ref in float32 compute|| (tests/test_torch_hybrid.py's
  ``_assert_within_bf16_noise``): both sides round bf16 products and
  activations at the same places but sum in other orders, and a rounding
  that lands one step apart is carried through both stacks.
  The bf16 caches of a bf16 decode are held the same way after each
  step, leaf by leaf, against the reference's float32 run's.
- bf16 cross k/v of a float32 computation: within one bf16 step at the
  larger magnitude, elementwise (two bf16 roundings of fp32 values within
  1e-4 of each other).
- loss and gradients: tests/test_torch_train_step.py's bars (float32:
  the loss within 1e-5 relative, each leaf within 1e-4 of its largest;
  bf16: the loss within 1e-2 absolute, each leaf within 1.5x the
  reference's own bf16-vs-float32 distance in the Frobenius norm); in
  crossbar kernel mode a float32 miss is excused only where the port's
  quantizers saw an input within 1e-4 of a code boundary (counted).
"""
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jcfg  # noqa: E402
from repro.dist.sharding import init_params as jinit  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.checkpoint import _key, _walk  # noqa: E402
from test_torch_hybrid import _assert_within_bf16_noise  # noqa: E402
from test_torch_train_step import _NearBoundary, _flat_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
TOL, MODEL_TOL, CHAIN_TOL = 1e-5, 1e-4, 2e-2
FULL_COUNT, FULL_XBAR_COUNT = 878_309_376, 1_493_037_056
SRC, TGT = 96, 64                   # source frames, target tokens
MODES = {"standard": {}, "kernel": dict(crossbar=True, xbar_use_kernel=True)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(4)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=str(what))


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, L),
                                                dtype=np.int32)


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a.copy()).to(td)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _within_one_bf16_step(got, want, what=""):
    """Elementwise within one bf16 step at the larger magnitude (+ 1e-6):
    two bf16 roundings of nearly equal fp32 values."""
    got, want = _f32(got), _f32(want)
    bar = _bf16_step(np.maximum(np.abs(got), np.abs(want))) + 1e-6
    assert (np.abs(got - want) <= bar).all(), (what,
                                               np.abs(got - want).max())


@functools.lru_cache(maxsize=None)
def _models(dtype, mode="standard"):
    """(reference model with jitted functions, its params, port model, the
    same params as CPU tensors) at the reduced config."""
    jc = jcfg.get_reduced_config(ARCH, compute_dtype=dtype, **MODES[mode])
    tc = tcfg.get_reduced_config(ARCH, compute_dtype=dtype, **MODES[mode])
    jm = jbuild(jc)
    jm = dataclasses.replace(jm, prefill_fn=jax.jit(jm.prefill_fn),
                             decode_fn=jax.jit(jm.decode_fn))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tbuild(tc, "cpu"), tp


@functools.lru_cache(maxsize=None)
def _encoded(dtype):
    """The reference's and the port's encoder states of the test frames."""
    jm, jp, tm, tp = _models(dtype)
    frames = _randn((2, SRC, 64), 1)
    want = jax.jit(functools.partial(jed.encode, jm.cfg))(
        jp, jnp.asarray(frames))
    return want, ted.encode(tm.cfg, tp, torch.from_numpy(frames))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"src_frames": rng.standard_normal((2, SRC, 64), np.float32),
            "tgt_tokens": rng.integers(0, 512, (2, TGT)).astype(np.int32),
            "labels": rng.integers(0, 512, (2, TGT)).astype(np.int32)}


def _hold(got, want, dtype, want32, what=""):
    """float32 within MODEL_TOL, bf16 within the reference's own bf16
    noise (module docstring)."""
    if dtype == "float32":
        _close(got, want, MODEL_TOL, what)
    else:
        _assert_within_bf16_noise(got, want, want32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_and_param_count_equal_the_reference():
    for getter in ("get_config", "get_reduced_config"):
        jc = getattr(jcfg, getter)(ARCH)
        tc = getattr(tcfg, getter)(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        xb = dict(crossbar=True)
        assert (tc.replace(**xb).param_count()
                == jc.replace(**xb).param_count())
        ja = dataclasses.asdict(jc.attn())
        assert dataclasses.asdict(tc.attn()) == {
            f.name: ja[f.name] for f in dataclasses.fields(tc.attn())}
    cfg = tcfg.get_config(ARCH)
    assert cfg.param_count() == FULL_COUNT
    assert cfg.replace(crossbar=True).param_count() == FULL_XBAR_COUNT
    assert (cfg.family, cfg.encoder_layers, cfg.n_layers) == ("encdec", 12,
                                                              12)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff) == (1024, 16, 16, 64, 4096)
    assert (cfg.mlp_act, cfg.gated_mlp, cfg.norm) == ("relu", False,
                                                      "layernorm")
    assert cfg.padded_vocab == 256256


def test_param_tree_carries_every_leaf():
    jm, jp, tm, tp = _models("float32", "kernel")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tshd.tree_leaves(tp)
    assert len(jleaves) == len(tleaves) > 0
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(_f32(b), np.asarray(a))
    # the spec's shapes, leaf for leaf, in the reference's (sorted) order
    spec = {_key(p): tuple(s.shape) for p, s in _walk(tm.spec)}
    assert spec == {"/".join(str(getattr(k, "key", k)) for k in path):
                    a.shape for path, a in jleaves}
    assert set(tp) == {"src_proj", "embed", "encoder", "enc_norm",
                       "decoder", "final_norm", "lm_head"}
    # src_proj stays a plain dense layer in crossbar mode, the head and
    # the blocks' projections are pairs
    assert set(tp["src_proj"]) == {"w"}
    assert set(tp["decoder"]["cross"]["wq"]) == {"g_plus", "g_minus"}
    assert set(tp["decoder"]) == {"ln1", "self", "ln_x", "cross", "ln2",
                                  "mlp"}
    assert set(tp["encoder"]["mlp"]) == {"wi", "wo"}       # not gated
    assert set(tp["enc_norm"]) == {"scale", "bias"}        # layernorm
    assert tp["decoder"]["self"]["wq"]["g_plus"].shape == (2, 64, 64)


# ---------------------------------------------------------------------------
# layers: layernorm, the relu MLP, attention bidirectional and cross
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    x = _randn((3, 7, 64), 2, 3.0) + 1.5
    params = {"scale": _randn((64,), 3) * 0.1 + 1.0,
              "bias": _randn((64,), 4) * 0.1}
    jx, tx = _pair(x, dtype)
    want = jax.jit(jnorms.layernorm_apply)(
        {k: jnp.asarray(v) for k, v in params.items()}, jx)
    got = tnorms.layernorm_apply(
        {k: torch.from_numpy(v) for k, v in params.items()}, tx)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "float32":
        _close(got, want, TOL)
    else:
        _within_one_bf16_step(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_mlp_matches_the_reference(dtype):
    cfg = tcfg.get_reduced_config(ARCH)
    spec = jmlp.mlp_spec(64, cfg.d_ff, gated=False)
    jp = jinit(jax.random.PRNGKey(5), spec)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == {"wi", "wo"}
    jx, tx = _pair(_randn((2, 9, 64), 6), dtype)
    jd, td = DTYPES[dtype]
    want = jax.jit(jmlp.mlp_apply, static_argnames=("act", "compute_dtype"))(
        jp, jx, act="relu", compute_dtype=jd)
    got = tmlp.mlp_apply(tp, tx, act="relu", compute_dtype=td)
    assert got.dtype == td
    _close(got, want, TOL if dtype == "float32" else CHAIN_TOL)


def _attn_cfgs(causal=True):
    cfg = tcfg.get_reduced_config(ARCH).attn()
    jc = jcfg.get_reduced_config(ARCH).attn()
    return (dataclasses.replace(jc, causal=causal),
            dataclasses.replace(cfg, causal=causal))


J_ATTN = jax.jit(jattn.attention_apply,
                 static_argnames=("cfg", "compute_dtype"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bidirectional", "cross kv_source",
                                  "cross cache", "cross cache, one query"])
def test_attention_apply_matches_the_reference(kind, dtype):
    """Bidirectional self-attention (RoPE on q and k, no causal mask) and
    cross-attention (no RoPE; k/v from ``kv_source`` or from a cross cache
    of other length; one query through ``decode_attention``)."""
    jac, tac = _attn_cfgs(causal=kind != "bidirectional")
    jp = jinit(jax.random.PRNGKey(7), jattn.attention_spec(jac))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jd, td = DTYPES[dtype]
    L = 1 if "one query" in kind else TGT
    jx, tx = _pair(_randn((2, L, 64), 8), dtype)
    pos = np.tile(np.arange(L), (2, 1))
    kw, tkw = {}, {}
    if kind == "cross kv_source":
        js, ts = _pair(_randn((2, SRC, 64), 9), dtype)
        kw, tkw = {"kv_source": js}, {"kv_source": ts}
    elif kind.startswith("cross cache"):
        k, v = _randn((2, SRC, 4, 16), 10), _randn((2, SRC, 4, 16), 11)
        (jk, tk), (jv, tv) = _pair(k, dtype), _pair(v, dtype)
        kw, tkw = {"cache": {"k": jk, "v": jv}}, {"cache": {"k": tk,
                                                             "v": tv}}
    want, jc = J_ATTN(jp, jx, cfg=jac, positions=jnp.asarray(pos),
                      compute_dtype=jd, **kw)
    before = tops.flash_attention.launches
    got, tc = tattn.attention_apply(tp, tx, tac,
                                    positions=torch.from_numpy(pos),
                                    compute_dtype=td, **tkw)
    assert tops.flash_attention.launches == before      # CPU: plain
    assert got.dtype == td and got.shape == (2, L, 64)
    _close(got, want, TOL if dtype == "float32" else CHAIN_TOL, kind)
    if kind.startswith("cross cache"):
        assert tc is tkw["cache"] and set(tc) == {"k", "v"}
    else:
        assert tc is None and jc is None


def test_cross_attention_fills_an_empty_cache_in_place():
    """A cache dict without ``"k"`` is filled from ``kv_source``; the next
    call reads it (no ``kv_source``) and gives the same output."""
    _, tac = _attn_cfgs()
    jp = jinit(jax.random.PRNGKey(7),
               jattn.attention_spec(_attn_cfgs()[0]))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x, src = torch.from_numpy(_randn((2, 1, 64), 12)), \
        torch.from_numpy(_randn((2, SRC, 64), 13))
    pos = torch.zeros(2, 1, dtype=torch.long)
    cache = {}
    a, c = tattn.attention_apply(tp, x, tac, positions=pos, cache=cache,
                                 kv_source=src, compute_dtype=torch.float32)
    assert c is cache and c["k"].shape == (2, SRC, 4, 16)
    b, _ = tattn.attention_apply(tp, x, tac, positions=pos, cache=cache,
                                 compute_dtype=torch.float32)
    assert torch.equal(a, b)


def _max_weighted_term(q, k, v, scale):
    """max_j p_j |v_j| / l of each non-causal output, p the plain
    softmax."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.float().reshape(B, Sq, K, H // K, hd),
                     k.float()) * scale
    p = torch.softmax(s, dim=-1)
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    t = (p[..., None] * va).amax(dim=-2)
    return _f32(t.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv", [(64, 96), (96, 64), (32, 128)],
                         ids=["Sq<Skv", "Sq>Skv", "Sq=Skv/4"])
def test_chunked_attention_non_causal_matches_the_reference(Sq, Skv, dtype):
    from repro.layers.attention import chunked_attention as j_chunked
    rng = np.random.default_rng(Sq + Skv)
    arrays = [rng.standard_normal(s, np.float32)
              for s in ((2, Sq, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    kw = dict(scale=0.25, causal=False, window=None, q_chunk=32,
              kv_chunk=32)
    want = jax.jit(j_chunked, static_argnames=tuple(kw))(jq, jk, jv, **kw)
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (2, Sq, 4, 16)
    if dtype == "float32":
        _close(got, want, 2e-5)
    else:
        g, w = _f32(got), _f32(want)
        bar = (_bf16_step(np.maximum(np.abs(g), np.abs(w))) + 1e-6
               + 2.0 ** -7 * _max_weighted_term(tq, tk, tv, 0.25))
        assert (np.abs(g - w) <= bar).all()


# ---------------------------------------------------------------------------
# the model: encode, the cross cache, prefill, decode, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(dtype):
    want, got = _encoded(dtype)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, SRC, 64)
    _hold(got, want, dtype, _encoded("float32")[0], "encode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fill_cross_cache_matches_the_reference(dtype):
    """The cross k/v of every decoder layer, in the cache dtype (bf16 by
    default, whatever the compute dtype)."""
    jm, jp, tm, tp = _models(dtype)
    (jenc, tenc), jenc32 = _encoded(dtype), _encoded("float32")[0]
    for cache_dtype in ("bfloat16", "float32"):
        jd, td = DTYPES[cache_dtype]
        kw = {} if cache_dtype == "bfloat16" else {"dtype": td}
        want = jed.fill_cross_cache(jm.cfg, jp, jenc, dtype=jd)
        want32 = jed.fill_cross_cache(_models("float32")[0].cfg,
                                      _models("float32")[1], jenc32,
                                      dtype=jnp.float32)
        got = ted.fill_cross_cache(tm.cfg, tp, tenc, **kw)
        assert set(got) == {"k", "v"}
        for name in ("k", "v"):
            assert got[name].dtype == td
            assert got[name].shape == (2, 2, SRC, 4, 16)
            if dtype == "float32" and cache_dtype == "bfloat16":
                _within_one_bf16_step(got[name], want[name], name)
            else:
                _hold(got[name], want[name], dtype, want32[name],
                      (cache_dtype, name))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_init_encdec_cache_matches_the_reference(dtype):
    """Leaf for leaf: shapes, dtypes and values; the default dtype is bf16
    whatever the config's ``kv_cache_dtype``."""
    jm, _, tm, _ = _models("float32")
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = jm.init_cache(2, 16, jd, src_len=SRC)
    got = tm.init_cache(2, 16, td, src_len=SRC)
    flat = _flat_ref(want)
    wdt = {"/".join(str(getattr(k, "key", k)) for k in path): a.dtype
           for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    tflat = {_key(p): t for p, t in _walk(got)}
    assert set(tflat) == set(flat)
    for k, t in tflat.items():
        assert tuple(t.shape) == flat[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(wdt[k]), k
        np.testing.assert_array_equal(_f32(t), flat[k], err_msg=k)
    assert got["self"]["length"].shape == (2,)
    assert got["cross"]["k"].shape == (2, 2, SRC, 4, 16)
    default = tm.init_cache(2, 16)
    assert default["cross"]["k"].dtype == default["self"]["k"].dtype \
        == torch.bfloat16
    assert tm.init_cache(2, 16)["cross"]["k"].shape[2] == 16  # src_len None
    # the leaves are distinct buffers: one layer's in-place update leaves
    # the others alone
    ptrs = [t.data_ptr() for t in tshd.tree_leaves(got)]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_the_reference(dtype):
    """96 source frames, 64 target tokens: the encoder's attention
    bidirectional at 96 x 96, the decoder's cross-attention at 64 x 96."""
    jm, jp, tm, tp = _models(dtype)
    batch = _batch()
    del batch["labels"]
    want = jm.prefill_fn(jp, jax.tree.map(jnp.asarray, batch))
    got = tm.prefill_fn(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (2, TGT, 512)
    want32 = (_models("float32")[0].prefill_fn(
        _models("float32")[1], jax.tree.map(jnp.asarray, batch))
        if dtype == "bfloat16" else None)
    _hold(got, want, dtype, want32, "prefill")


def _decode_run(dtype, model, params, enc, tokens, is_ref):
    """6 decode steps over a cache whose cross k/v are filled from the
    encoder's output, in the compute dtype; the logits and each step's
    cache leaves."""
    cache_dtype = DTYPES[dtype][0 if is_ref else 1]
    if is_ref:
        cache = model.init_cache(2, 8, cache_dtype, src_len=SRC)
        cache["cross"] = jed.fill_cross_cache(model.cfg, params, enc,
                                              cache_dtype)
    else:
        cache = model.init_cache(2, 8, cache_dtype, src_len=SRC)
        cache["cross"] = ted.fill_cross_cache(model.cfg, params, enc,
                                              cache_dtype)
    logits, caches = [], []
    for step in range(6):
        tok = tokens[:, step:step + 1]
        batch = ({"tokens": jnp.asarray(tok), "length": jnp.int32(step)}
                 if is_ref else {"tokens": torch.from_numpy(tok),
                                 "length": step})
        out, cache = model.decode_fn(params, cache, batch)
        logits.append(_f32(out))
        # copies: the port's cache is written in place by the next step
        caches.append(_flat_ref(cache) if is_ref else
                      {_key(p): _f32(t).copy() for p, t in _walk(cache)})
    return np.concatenate(logits, axis=1), caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_reference(dtype):
    """6 ``decode_fn`` steps with the cross cache filled (in the compute
    dtype), the logits and every cache leaf held after each step; the
    port's caches are written in place."""
    jm, jp, tm, tp = _models(dtype)
    jenc, tenc = _encoded(dtype)
    tok = _tokens(2, 6, 3)
    want, jcaches = _decode_run(dtype, jm, jp, jenc, tok, True)
    cache = tm.init_cache(2, 8, DTYPES[dtype][1], src_len=SRC)
    buffers = [t.data_ptr() for t in tshd.tree_leaves(cache)]
    got, tcaches = _decode_run(dtype, tm, tp, tenc, tok, False)
    if dtype == "bfloat16":
        jm32, jp32, _, _ = _models("float32")
        want32, jcaches32 = _decode_run("float32", jm32, jp32,
                                        _encoded("float32")[0], tok, True)
    for step, (jc, tc) in enumerate(zip(jcaches, tcaches)):
        assert set(tc) == set(jc)
        assert tc["self/length"].tolist() == [step + 1] * 2
        for k, w in jc.items():
            if dtype == "float32" or k in ("self/pos", "self/length"):
                _close(tc[k], w, MODEL_TOL, (step, k))
            else:
                _assert_within_bf16_noise(tc[k], w, jcaches32[step][k])
    _hold(got, want, dtype, want32 if dtype == "bfloat16" else None)
    # in place: decode_fn returns the cache it was given
    out, same = tm.decode_fn(tp, cache, {"tokens": torch.from_numpy(
        tok[:, :1]), "length": 0})
    assert same is cache
    assert [t.data_ptr() for t in tshd.tree_leaves(cache)] == buffers


def test_decode_equals_prefill_in_the_port():
    """float32 compute and caches: 12 teacher-forced decode steps within
    1e-4 of the port's own prefill on the same source and tokens."""
    _, _, tm, tp = _models("float32")
    frames = torch.from_numpy(_randn((2, SRC, 64), 14))
    tok = torch.from_numpy(_tokens(2, 12, 4))
    pre = tm.prefill_fn(tp, {"src_frames": frames, "tgt_tokens": tok})
    cache = tm.init_cache(2, 12, torch.float32, src_len=SRC)
    cache["cross"] = ted.fill_cross_cache(
        tm.cfg, tp, ted.encode(tm.cfg, tp, frames), torch.float32)
    dec = []
    for step in range(12):
        logits, cache = tm.decode_fn(tp, cache, {
            "tokens": tok[:, step:step + 1], "length": step})
        dec.append(logits)
    _close(torch.cat(dec, dim=1), pre, MODEL_TOL)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(mode, dtype):
    jm, jp, _, _ = _models(dtype, mode)
    batch = jax.tree.map(jnp.asarray, _batch(1))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, batch)
    assert set(metrics) == {"ce"}
    return float(loss), _flat_ref(grads)


def _nrel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode,dtype", [("standard", "float32"),
                                        ("standard", "bfloat16"),
                                        ("kernel", "float32")])
def test_loss_and_grads_match_the_reference(mode, dtype, monkeypatch):
    """remat "full" (each encoder and decoder layer recomputed): the loss,
    ``{"ce"}`` alone (no aux term), and every gradient leaf, the
    encoder's and ``src_proj``'s included, against ``jax.value_and_grad``
    (module docstring)."""
    near = _NearBoundary(monkeypatch)
    _, _, tm, tp = _models(dtype, mode)
    assert tm.cfg.remat == "full"
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tshd.tree_leaves(tp)]
    it = iter(leaves)
    live = tshd.tree_map(lambda _: next(it), tp)
    loss, metrics = tm.loss_fn(live, {k: torch.from_numpy(v)
                                      for k, v in _batch(1).items()})
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == {"ce"} and metrics["ce"] is loss
    got = {_key(path): g.to(torch.float32).numpy()
           for (path, _), g in zip(_walk(live), grads)}
    want_loss, want = _ref_loss_grads(mode, dtype)
    assert set(got) == set(want)
    assert all(np.abs(got[k]).max() > 0 for k in got)
    loss = float(loss.detach())
    if dtype == "bfloat16":
        _, want32 = _ref_loss_grads(mode, "float32")
        assert abs(loss - want_loss) <= 1e-2
        for k, w in want.items():
            noise = _nrel(w, want32[k])
            assert _nrel(got[k], w) <= 1.5 * noise + 1e-6, (k, noise)
        return
    strict = abs(loss - want_loss) <= 1e-5 * abs(want_loss) and all(
        np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max()
        for k, w in want.items())
    if not strict:          # excused only next to a code boundary
        print(f"{mode}: off the fp32 bar with {near.count} quantizer "
              f"inputs near a code boundary")
        assert mode == "kernel" and near.count > 0
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        for k, w in want.items():
            assert _nrel(got[k], w) <= 0.1, k


def test_crossbar_loss_in_bf16_matches_the_reference():
    """Crossbar kernel mode in bf16 compute: the loss within 1e-2 (the
    bf16 logit bar of tests/test_torch_lm.py); its gradients are held in
    float32 above (the reference's bf16 kernel-mode gradient compiles for
    longer than this file's budget)."""
    jm, jp, tm, tp = _models("bfloat16", "kernel")
    batch = _batch(1)
    want, metrics = jax.jit(jm.loss_fn)(jp, jax.tree.map(jnp.asarray, batch))
    got, tmet = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert set(tmet) == set(metrics) == {"ce"}
    assert abs(float(got.detach()) - float(want)) <= 1e-2


def test_chip_smoke_bf16_decode_figure_is_the_references():
    """``chip_smoke.py`` holds bf16 decode against bf16 prefill at full
    width within 2 d, d = ``ENCDEC_BF16_DIST``: the reference's own
    bf16-vs-float32 relative distance of its prefill logits on its
    reduced config, the largest over 8 batches of 4 x 24 tokens on 32
    source frames from numpy seeds 0-7.  The figure written in the script
    is the reference's, measured here; and the port's own bf16 decode
    against its bf16 prefill on the reduced config lies within 2 d."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fns = {d: _models(d)[0].prefill_fn for d in ("bfloat16", "float32")}
    jp = _models("float32")[1]
    dists = []
    for seed in range(8):
        b = {"src_frames": jnp.asarray(_randn((4, 32, 64), 100 + seed)),
             "tgt_tokens": jnp.asarray(_tokens(4, 24, seed))}
        a, f = (np.asarray(fns[d](jp, b), np.float32)
                for d in ("bfloat16", "float32"))
        dists.append(np.linalg.norm(a - f) / np.linalg.norm(f))
    d = smoke.ENCDEC_BF16_DIST
    assert f"{max(dists):.4g}" == f"{d:.4g}", (max(dists), d)
    _, _, tm, tp = _models("bfloat16")
    frames = torch.from_numpy(_randn((4, 32, 64), 109))
    tok = torch.from_numpy(_tokens(4, 24, 9))
    pre = tm.prefill_fn(tp, {"src_frames": frames, "tgt_tokens": tok})
    cache = tm.init_cache(4, 24, src_len=32)
    cache["cross"] = ted.fill_cross_cache(tm.cfg, tp,
                                          ted.encode(tm.cfg, tp, frames))
    dec = []
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
    """``BatchedServer`` in float32 compute with float32 caches, its cross
    cache filled from the same frames on both sides, 8-token prompts and
    16 new tokens (23 decode steps, one padded slot): the same stats and
    tokens as the reference's server."""
    jm, jp, tm, tp = _models("float32")
    frames = _randn((4, 32, 64), 15)
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=32,
                              cache_dtype=jnp.float32)
    js.cache = jm.init_cache(4, 32, jnp.float32, src_len=32)
    js.cache["cross"] = jed.fill_cross_cache(
        jm.cfg, jp, jed.encode(jm.cfg, jp, jnp.asarray(frames)),
        jnp.float32)
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=32,
                              cache_dtype=torch.float32)
    ts.cache = tm.init_cache(4, 32, torch.float32, src_len=32)
    ts.cache["cross"] = ted.fill_cross_cache(
        tm.cfg, tp, ted.encode(tm.cfg, tp, torch.from_numpy(frames)),
        torch.float32)
    want = js.generate(PROMPTS[:3], 16)
    got = ts.generate(PROMPTS[:3], 16)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.steps == 23 and ts.stats.tokens_out == 64
    assert got == want


def test_serve_cli_on_cpu(capsys):
    """``launch.serve --arch seamless-m4t-medium --reduced --device cpu``:
    the decoder over the zero cross cache of 256 source slots."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "128 tokens in" in lines[-1] and "(39 decode steps)" in lines[-1]


def test_train_cli_refuses_the_encoder_decoder():
    """The CLI's ``TokenStream`` batches carry no ``src_frames`` (the
    reference's CLI cannot train this family either): a clear error."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="src_frames"):
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "1"])


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tcfg.get_config(ARCH))
    model = tbuild(tcfg.get_reduced_config(ARCH), "meta")
    assert model.device == torch.device("meta")
    specs = model.input_specs("train", 32, 2)
    assert specs == {"src_frames": ((2, 32, 64), torch.float32),
                     "tgt_tokens": ((2, 32), torch.int32),
                     "labels": ((2, 32), torch.int32)}
    batch, cache = model.input_specs("decode", 32, 2)
    assert cache["cross"]["k"] == ((2, 2, 32, 4, 16), torch.bfloat16)
    assert batch["tokens"] == ((2, 1), torch.int32)
