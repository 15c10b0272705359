"""Port parity: the VLM family (qwen2-vl-72b: M-RoPE, the patch merger)
of ``repro_torch`` against ``repro``'s, on the CPU.

The models take the reference's ``model.init(PRNGKey(0))`` parameters,
carried across by ``interop.lm_params_from_numpy``, at the reduced config
(d 64, 2 layers, 4 heads on 2 of 16, sections (4, 2, 2), 8 patches, vocab
512, chunks of 32); the inputs, ``patch_embeds`` among them, are numpy
draws from fixed seeds.  ``apply_mrope`` is held at qwen2-vl's own head
(hd 128, sections (16, 24, 24)) and the reduced one, on three distinct
position streams drawn per token (where the streams are equal, a wrong
section order gives the same result), the reference called unjitted as
in tests/test_torch_lm_layers.py (jitted, XLA's cos and sin move by up
to 6.1e-5 at positions to 2048).

Tolerances, each with its reason:
- the angles of ``apply_mrope``: equal bit for bit (the same fp32
  products on both sides).
- rope values: fp32 within 1e-6 (cos and sin differ by an ulp between
  the two libms at positions to 2048 and theta 1e6); bf16 within one
  bf16 step at the larger magnitude (one rounding of nearly equal fp32
  values).
- the port's ``apply_mrope`` on text positions against its ``apply_rope``:
  bit for bit (the same products).
- layers (``attention_apply``, ``embed_inputs``): fp32 within 1e-5
  absolute plus relative, bf16 within 2e-2 (the chained bf16 bar of
  tests/test_torch_lm_layers.py).
- the model's outputs (logits, caches): float32 within 1e-4 (fp32 sums
  in other orders through two layers, the bar of tests/test_torch_lm.py);
  bf16 in the Frobenius norm within the reference's own bf16 noise,
  ||port - ref|| <= ||ref - ref in float32 compute||
  (tests/test_torch_hybrid.py's ``_assert_within_bf16_noise``).
- loss and gradients, in float32: tests/test_torch_train_step.py's bars
  (the loss within 1e-5 relative, each leaf within 1e-4 of its largest);
  in crossbar kernel mode a
  float32 miss is excused only where the port's quantizers saw an input
  within 1e-4 of a code boundary (counted), then held with the loss
  within 1e-4 relative and each leaf within 10 % in the norm.
- a checkpoint: none (arrays stored and restored whole).
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
from repro.layers import rope as jrope  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import rope as trope  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import checkpoint as tckpt  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.runtime.checkpoint import _key, _walk  # noqa: E402
from test_torch_hybrid import _assert_within_bf16_noise  # noqa: E402
from test_torch_train_step import _NearBoundary, _flat_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-vl-72b"
TOL, MODEL_TOL, CHAIN_TOL = 1e-5, 1e-4, 2e-2
FULL_COUNT = 72_773_312_512
P, L = 8, 32                        # patches, tokens of a prefill
MODES = {"standard": {}, "kernel": dict(crossbar=True, xbar_use_kernel=True)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _within_one_bf16_step(got, want, what=""):
    """Elementwise within one bf16 step at the larger magnitude (+ 1e-6)."""
    got, want = _f32(got), _f32(want)
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    bar = np.ldexp(np.float32(1.0), e - 8) + 1e-6
    assert (np.abs(got - want) <= bar).all(), (what,
                                               np.abs(got - want).max())


def _batch(B=2, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 512, (B, L)).astype(np.int32),
             "patch_embeds": rng.standard_normal((B, P, 64), np.float32)}
    if labels:
        batch["labels"] = rng.integers(0, 512, (B, L)).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _params(mode):
    """The reference's ``model.init(PRNGKey(0))`` parameters (fp32 whatever
    the compute dtype) and the same as CPU tensors."""
    jp = jbuild(jcfg.get_reduced_config(ARCH, **MODES[mode])).init(
        jax.random.PRNGKey(0))
    return jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


@functools.lru_cache(maxsize=None)
def _models(dtype, mode="standard"):
    """(reference model with jitted functions, its params, port model, the
    same params as CPU tensors) at the reduced config."""
    jc = jcfg.get_reduced_config(ARCH, compute_dtype=dtype, **MODES[mode])
    tc = tcfg.get_reduced_config(ARCH, compute_dtype=dtype, **MODES[mode])
    jm = jbuild(jc)
    jm = dataclasses.replace(jm, prefill_fn=jax.jit(jm.prefill_fn),
                             decode_fn=jax.jit(jm.decode_fn))
    return (jm, *_params(mode)[:1], tbuild(tc, "cpu"), _params(mode)[1])


def _hold(got, want, dtype, want32, what=""):
    """float32 within MODEL_TOL, bf16 within the reference's own bf16
    noise (module docstring)."""
    if dtype == "float32":
        _close(got, want, MODEL_TOL, what)
    else:
        _assert_within_bf16_noise(got, want, want32)


# ---------------------------------------------------------------------------
# configs and the parameter tree
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
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (
                "vlm", 80, 8192, 64, 8, 128, 29568)
    assert (cfg.mrope_sections, cfg.vlm_patches, cfg.rope_theta,
            cfg.grad_accum, cfg.qkv_bias) == ((16, 24, 24), 256, 1e6, 4,
                                              True)
    assert cfg.padded_vocab == cfg.vocab_size == 152064
    red = tcfg.get_reduced_config(ARCH)
    assert (red.mrope_sections, red.vlm_patches, red.q_chunk) == (
        (4, 2, 2), 8, 32)


def test_param_tree_carries_every_leaf():
    """Leaf for leaf across ``interop`` both ways, kernel mode included:
    the patch merger stays a plain dense layer (no bias, no crossbar)."""
    for mode in MODES:
        jm, jp, tm, tp = _models("float32", mode)
        jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
        tleaves = tshd.tree_leaves(tp)
        assert len(jleaves) == len(tleaves) > 0
        for (path, a), b in zip(jleaves, tleaves):
            assert tuple(b.shape) == a.shape, path
            np.testing.assert_array_equal(_f32(b), np.asarray(a))
        spec = {_key(p): tuple(s.shape) for p, s in _walk(tm.spec)}
        assert spec == {"/".join(str(getattr(k, "key", k)) for k in path):
                        a.shape for path, a in jleaves}
        assert set(tp["patch_merger"]) == {"w"}
        assert tp["patch_merger"]["w"].shape == (64, 64)
        back = interop.lm_params_to_numpy(tp)
        for (path, a), b in zip(jleaves, jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, np.asarray(a))
    assert set(tp["stack"]["b0_attn"]["attn"]["wq"]) == {"g_plus",
                                                         "g_minus", "b"}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

class _Cos:
    """Stands in for a module inside rope.py and records what its ``cos``
    is given: the angles, read from each side's own function."""

    def __init__(self, mod):
        self._mod, self.angles = mod, []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def cos(self, a):
        self.angles.append(a)
        return self._mod.cos(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (16, (4, 2, 2))],
                         ids=["qwen2-vl", "reduced"])
def test_mrope_on_distinct_streams_matches_the_reference(hd, sections,
                                                         dtype, monkeypatch):
    rng = np.random.default_rng(hd)
    pos3 = rng.integers(0, 2048, (2, 256, 3))
    x = _randn((2, 256, 4, hd), 4)
    jx, tx = _pair(x, dtype)
    jrec, trec = _Cos(jnp), _Cos(torch)
    monkeypatch.setattr(jrope, "jnp", jrec)
    monkeypatch.setattr(trope, "torch", trec)
    want = jrope.apply_mrope(jx, jnp.asarray(pos3), sections, theta=1e6)
    got = trope.apply_mrope(tx, torch.from_numpy(pos3), sections, theta=1e6)
    monkeypatch.undo()
    (ja,), (ta,) = jrec.angles, trec.angles
    assert ta.dtype == torch.float32 and tuple(ta.shape) == ja.shape
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert got.dtype == DTYPES[dtype][1] and got.shape == tx.shape
    if dtype == "float32":
        _close(got, want, 1e-6)
    else:
        _within_one_bf16_step(got, want)


def test_mrope_section_order_matters():
    """A swapped section order moves the rotation wherever the streams
    differ: the test above would catch it."""
    pos3 = torch.from_numpy(np.random.default_rng(1).integers(0, 2048,
                                                              (1, 16, 3)))
    x = torch.from_numpy(_randn((1, 16, 2, 16), 5))
    a = trope.apply_mrope(x, pos3, (4, 2, 2), theta=1e6)
    b = trope.apply_mrope(x, pos3[..., [1, 0, 2]], (4, 2, 2), theta=1e6)
    assert not torch.equal(a, b)
    with pytest.raises(AssertionError):
        trope.apply_mrope(x, pos3, (4, 2, 1))


def test_text_mrope_positions_match_the_reference():
    """(B, L) -> (B, L, 3), the streams equal, a view with no copy; a 0-d
    tensor ``start`` (a decode step's length) needs no host read."""
    pos = np.tile(np.arange(7), (2, 1)) + 3
    want = jrope.text_mrope_positions(jnp.asarray(pos))
    got = trope.text_mrope_positions(torch.from_numpy(pos))
    assert tuple(got.shape) == want.shape == (2, 7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    base = torch.from_numpy(pos)
    assert trope.text_mrope_positions(base).data_ptr() == base.data_ptr()
    cfg = tcfg.get_reduced_config(ARCH)
    start = torch.tensor(5)
    got = tmodel._positions_for(cfg, 2, 1, device=torch.device("cpu"),
                                start=start)
    assert tuple(got.shape) == (2, 1, 3) and got.stride(-1) == 0
    assert got.tolist() == [[[5, 5, 5]]] * 2
    dense = tcfg.get_reduced_config("qwen2-0.5b")
    assert tuple(tmodel._positions_for(dense, 2, 4,
                                       device=torch.device("cpu")).shape) \
        == (2, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,sections", [(16, (4, 2, 2)), (64, (8, 12, 12)),
                                         (128, (16, 24, 24))])
def test_mrope_on_text_positions_is_rope_bit_for_bit(hd, sections, dtype):
    """The same products on the same frequencies, so the same values in
    every band: band 37 of hd 128 at theta 1e6 too, where torch's fp32
    ``theta ** e`` is an ulp off XLA's and both rotations take the
    float64 power rounded once (``rope._rope_freqs``)."""
    pos = np.tile(np.arange(2048), (2, 1))
    x = torch.from_numpy(_randn((2, 2048, 4, hd), 6)).to(DTYPES[dtype][1])
    tpos = torch.from_numpy(pos)
    a = trope.apply_mrope(x, trope.text_mrope_positions(tpos), sections,
                          theta=1e6)
    b = trope.apply_rope(x, tpos, theta=1e6)
    e = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    off = ((1e6 ** e) != (1e6 ** e.double()).float()).nonzero()[:, 0]
    assert off.tolist() == ([37] if hd == 128 else [])
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# layers: attention with M-RoPE, the patch merge
# ---------------------------------------------------------------------------

J_ATTN = jax.jit(jattn.attention_apply,
                 static_argnames=("cfg", "compute_dtype"))


def _attn():
    jac = jcfg.get_reduced_config(ARCH).attn()
    tac = tcfg.get_reduced_config(ARCH).attn()
    jp = jinit(jax.random.PRNGKey(7), jattn.attention_spec(jac))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jac, tac, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_with_mrope_matches_the_reference(dtype):
    """Prefill on distinct (t, h, w) streams; then 6 decode steps over a
    cache of the compute dtype at text positions, the cache held after
    each step."""
    jac, tac, jp, tp = _attn()
    assert tac.mrope_sections == (4, 2, 2)
    jd, td = DTYPES[dtype]
    tol = TOL if dtype == "float32" else CHAIN_TOL
    jx, tx = _pair(_randn((2, L, 64), 8), dtype)
    pos3 = np.random.default_rng(9).integers(0, 2048, (2, L, 3))
    want, _ = J_ATTN(jp, jx, cfg=jac, positions=jnp.asarray(pos3),
                     compute_dtype=jd)
    got, cache = tattn.attention_apply(tp, tx, tac,
                                       positions=torch.from_numpy(pos3),
                                       compute_dtype=td)
    assert cache is None and got.dtype == td
    _close(got, want, tol, "prefill")
    jc = jattn.init_self_cache(jac, 2, 8, jd)
    tc = tattn.init_self_cache(tac, 2, 8, td, "cpu")
    for step in range(6):
        jx, tx = _pair(_randn((2, 1, 64), 10 + step), dtype)
        pos = np.full((2, 1), step)
        want, jc = J_ATTN(jp, jx, cfg=jac, positions=jrope.
                          text_mrope_positions(jnp.asarray(pos)), cache=jc,
                          compute_dtype=jd)
        got, tc = tattn.attention_apply(
            tp, tx, tac, positions=trope.text_mrope_positions(
                torch.from_numpy(pos)), cache=tc, compute_dtype=td)
        _close(got, want, tol, ("decode", step))
        for name in ("k", "v"):
            _close(tc[name], jc[name], tol, (step, name))
    assert int(tc["length"]) == 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_matches_the_reference(dtype):
    """With ``patch_embeds`` the merger's output replaces token positions
    0 .. P-1 and the rest are the token embeddings; without them nothing
    is merged."""
    jm, jp, tm, tp = _models("float32")
    jd, td = DTYPES[dtype]
    batch = _batch(labels=False)
    fn = jax.jit(jlm.embed_inputs, static_argnums=(0, 3))
    out = []
    for b in (batch, {"tokens": batch["tokens"]}):
        want = fn(jm.cfg, jp, jax.tree.map(jnp.asarray, b), jd)
        out.append(tlm.embed_inputs(tm.cfg, tp, _torch_batch(b), td))
        assert out[-1].dtype == td and out[-1].shape == (2, L, 64)
        _close(out[-1], want, TOL if dtype == "float32" else CHAIN_TOL,
               sorted(b))
    merged, plain = out
    assert torch.equal(merged[:, P:], plain[:, P:])
    assert not torch.equal(merged[:, :P], plain[:, :P])


# ---------------------------------------------------------------------------
# the model: prefill, decode, loss and gradients, the training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_matches_the_reference(dtype):
    jm, jp, tm, tp = _models(dtype)
    batch = _batch(labels=False)
    want = jm.prefill_fn(jp, jax.tree.map(jnp.asarray, batch))
    got = tm.prefill_fn(tp, _torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == (2, L, 512)
    want32 = (_models("float32")[0].prefill_fn(
        _models("float32")[1], jax.tree.map(jnp.asarray, batch))
        if dtype == "bfloat16" else None)
    _hold(got, want, dtype, want32, "prefill")


def _decode_run(model, params, dtype, tokens, is_ref):
    """6 decode steps over a cache of the compute dtype: the logits and
    each step's cache leaves."""
    cache = model.init_cache(2, 8, DTYPES[dtype][0 if is_ref else 1])
    logits, caches = [], []
    for step in range(6):
        tok = tokens[:, step:step + 1]
        batch = ({"tokens": jnp.asarray(tok), "length": jnp.int32(step)}
                 if is_ref else {"tokens": torch.from_numpy(tok),
                                 "length": torch.tensor(step)})
        out, cache = model.decode_fn(params, cache, batch)
        logits.append(_f32(out))
        # copies: the port's cache is written in place by the next step
        caches.append(_flat_ref(cache) if is_ref else
                      {_key(p): _f32(t).copy() for p, t in _walk(cache)})
    return np.concatenate(logits, axis=1), caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_reference(dtype):
    """6 ``decode_fn`` steps (M-RoPE at text positions, the length a 0-d
    tensor), the logits and every cache leaf held after each step."""
    jm, jp, tm, tp = _models(dtype)
    tok = _tokens(2, 6, 3)
    want, jcaches = _decode_run(jm, jp, dtype, tok, True)
    got, tcaches = _decode_run(tm, tp, dtype, tok, False)
    if dtype == "bfloat16":
        want32, jcaches32 = _decode_run(*_models("float32")[:2], "float32",
                                        tok, True)
    for step, (jc, tc) in enumerate(zip(jcaches, tcaches)):
        assert set(tc) == set(jc)
        for k, w in jc.items():
            if dtype == "float32" or k.endswith("length"):
                _close(tc[k], w, MODEL_TOL, (step, k))
            else:
                _assert_within_bf16_noise(tc[k], w, jcaches32[step][k])
    _hold(got, want, dtype, want32 if dtype == "bfloat16" else None)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(mode, dtype):
    jm, jp, _, _ = _models(dtype, mode)
    batch = jax.tree.map(jnp.asarray, _batch(seed=1))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, batch)
    return float(loss), _flat_ref(grads)


def _nrel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", ["standard", "kernel"])
def test_loss_and_grads_match_the_reference(mode, monkeypatch):
    """remat "full", float32: the loss and every gradient leaf, the patch
    merger's and the embedding's included, against
    ``jax.value_and_grad`` (bf16 is held at the logits above: the
    reference's bf16 gradients would compile past this file's budget)."""
    near = _NearBoundary(monkeypatch)
    _, _, tm, tp = _models("float32", mode)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tshd.tree_leaves(tp)]
    it = iter(leaves)
    live = tshd.tree_map(lambda _: next(it), tp)
    loss, metrics = tm.loss_fn(live, _torch_batch(_batch(seed=1)))
    grads = torch.autograd.grad(loss, leaves)
    got = {_key(path): g.to(torch.float32).numpy()
           for (path, _), g in zip(_walk(live), grads)}
    want_loss, want = _ref_loss_grads(mode, "float32")
    assert set(got) == set(want)
    assert np.abs(got["patch_merger/w"]).max() > 0
    loss = float(loss.detach())
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


def test_train_step_with_grad_accum_matches_the_reference():
    """One adamw step of ``make_train_step`` at the config's
    ``grad_accum`` (4: microbatches of one row, ``patch_embeds`` sliced
    along the batch with the tokens): the metrics within 1e-5 relative,
    the gradients (the first moment / 0.1) within 1e-4 of each leaf's
    largest, the parameters within 1e-6 (2 lr where |g| is below 1e-3 of
    its leaf's largest: tests/test_torch_train_step.py's reason).  Crossbar
    kernel mode's gradients are held above; chip_smoke.py holds its
    ``grad_accum=4`` step on the card against the CPU."""
    jm, jp, tm, _ = _models("float32")
    k = tm.cfg.grad_accum
    assert k == jm.cfg.grad_accum == 4
    batch = _batch(B=4, seed=2)
    jopt, topt = jadamw(1e-3), tadamw(1e-3)
    jnew, jstate, jmet = jax.jit(jtrain.make_train_step(
        jm, jopt, grad_accum=k))(jp, jopt.init(jp),
                                 jax.tree.map(jnp.asarray, batch), 0)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tnew, tstate, tmet = ttrain.make_train_step(tm, topt, grad_accum=k)(
        tp, topt.init(tp), _torch_batch(batch), 0)
    g_ref = {n: m / 0.1 for n, m in _flat_ref(jstate["m"]).items()}
    g_got = {_key(p): t.numpy() / 0.1 for p, t in _walk(tstate["m"])}
    want = _flat_ref(jnew)
    assert np.abs(g_ref["patch_merger/w"]).max() > 0

    for n in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[n]), float(jmet[n]),
                                   rtol=1e-5, err_msg=n)
    for n, g in g_ref.items():
        assert np.abs(g_got[n] - g).max() <= 1e-4 * np.abs(g).max(), n
    for path, t in _walk(tnew):
        n = _key(path)
        g = np.abs(g_ref[n])
        small = g <= 1e-3 * g.max()
        err = np.abs(t.numpy() - want[n])
        assert (err[~small] <= 1e-6).all(), (n, err[~small].max())
        assert (err[small] <= 2e-3 + 1e-6).all(), n


def test_checkpoint_carries_the_patch_merger_across_packages(tmp_path):
    """The port's checkpoint restores in the reference and the
    reference's in the port, ``patch_merger`` and every other leaf equal;
    a restored model gives the same prefill."""
    jm, jp, tm, tp = _models("float32")
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(pdir, 3, {"params": tp}, extra={"arch": tm.cfg.name})
    jckpt.save(jdir, 4, {"params": jp}, extra={"arch": jm.cfg.name})
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        jp)
    jgot, step, extra = jckpt.restore(pdir, {"params": like})
    assert step == 3 and extra == {"arch": "qwen2-vl-72b-reduced"}
    tgot, step, _ = tckpt.restore(jdir, {"params": tm.abstract_params()},
                                  device="cpu")
    assert step == 4
    flat = _flat_ref(jp)
    assert "patch_merger/w" in flat
    for name, tree in (("reference", _flat_ref(jgot["params"])),
                       ("port", {_key(p): t.numpy()
                                 for p, t in _walk(tgot["params"])})):
        assert set(tree) == set(flat), name
        for n, w in flat.items():
            np.testing.assert_array_equal(tree[n], w, err_msg=(name, n))
    batch = _torch_batch(_batch(labels=False))
    assert torch.equal(tm.prefill_fn(tgot["params"], batch),
                       tm.prefill_fn(tp, batch))


# ---------------------------------------------------------------------------
# the chip script's bf16 figure, the CLI, the device
# ---------------------------------------------------------------------------

def test_chip_smoke_bf16_decode_figure_is_the_references():
    """``chip_smoke.py`` holds bf16 decode against bf16 prefill at full
    width within 2 d, d = ``VLM_BF16_DIST``: the reference's own
    bf16-vs-float32 relative distance of its prefill logits on its
    reduced config (text only, as the served prompts), the largest over 8
    batches of 4 x 24 tokens from numpy seeds 0-7.  The figure written in
    the script is the reference's, measured here; and the port's own bf16
    decode against its bf16 prefill on the reduced config lies within
    2 d."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fns = {d: _models(d)[0].prefill_fn for d in ("bfloat16", "float32")}
    jp = _models("float32")[1]
    dists = []
    for seed in range(8):
        b = {"tokens": jnp.asarray(_tokens(4, 24, seed))}
        a, f = (np.asarray(fns[d](jp, b), np.float32)
                for d in ("bfloat16", "float32"))
        dists.append(np.linalg.norm(a - f) / np.linalg.norm(f))
    d = smoke.VLM_BF16_DIST
    assert f"{max(dists):.4g}" == f"{d:.4g}", (max(dists), d)
    _, _, tm, tp = _models("bfloat16")
    tok = torch.from_numpy(_tokens(4, 24, 9))
    pre = tm.prefill_fn(tp, {"tokens": tok})
    cache = tm.init_cache(4, 24)
    dec = []
    for step in range(24):
        logits, cache = tm.decode_fn(tp, cache, {
            "tokens": tok[:, step:step + 1], "length": step})
        dec.append(logits)
    rel = float(torch.linalg.norm(torch.cat(dec, dim=1) - pre)
                / torch.linalg.norm(pre))
    print(f"d = {d}, the port's bf16 decode vs prefill {rel:.4f}")
    assert rel <= 2 * d


def test_serve_cli_on_cpu(capsys):
    """``launch.serve --arch qwen2-vl-72b --reduced --device cpu``: text
    only, as the reference's CLI (its prompts carry no patches)."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "128 tokens in" in lines[-1] and "(39 decode steps)" in lines[-1]


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tcfg.get_config(ARCH))
    model = tbuild(tcfg.get_reduced_config(ARCH), "meta")
    for kind in ("train", "prefill"):
        specs = model.input_specs(kind, 32, 2)
        assert specs["patch_embeds"] == ((2, 8, 64), torch.float32)
        assert specs["tokens"] == ((2, 32), torch.int32)
    assert set(model.input_specs("train", 32, 2)) == {
        "tokens", "labels", "patch_embeds"}
    batch, _ = model.input_specs("decode", 32, 2)
    assert set(batch) == {"tokens", "length"}
