"""Port parity: the LM training step of ``repro_torch`` (``Model.loss_fn``
under autograd, ``runtime.train_loop.make_train_step``, remat, the
attention backward, the bf16 crossbar kernel path) against ``repro``'s
(``jax.value_and_grad(model.loss_fn)``, its ``make_train_step``,
``jax.vjp`` of ``chunked_attention``) on the reduced qwen2-0.5b and yi-6b
configs, with the reference's ``model.init(PRNGKey(0))`` parameters
carried across (``interop.lm_params_from_numpy``) and seeded numpy tokens.

Tolerances, each with its reason:
- float32 compute: the loss within 1e-5 relative; each gradient leaf
  within 1e-4 of its largest magnitude, elementwise (fp32 sums in other
  orders through two layers, the softmax and the cross-entropy; measured
  1.5e-6 in the Frobenius norm).  A crossbar mode's activation and error
  quantizers round x / scale; where one of their inputs lies within 1e-4
  of a half-integer code boundary, a last-bit difference upstream may
  move that code by one step, which moves every later value.  A case
  that misses the bar above is excused only if the port's quantizers
  saw such near-boundary inputs (counted and printed); it is then held
  with the loss within 1e-4 relative and each leaf within 10 % in the
  Frobenius norm (one case: yi-6b in the (w, common-mode) mode, where
  one activation code moves).
- bf16 compute: both sides round at different places (XLA keeps excess
  precision inside fused elementwise chains), so each leaf's gradient is
  held, in the Frobenius norm, within 1.5x the distance between the
  reference's own bf16 and fp32 gradients (measured at most 1.1x); the
  loss within 1e-2 absolute (the bf16 logit bar of tests/test_torch_lm.py).
- one ``make_train_step`` step with adamw: the optimizer's moments at
  the gradient bar, the metrics within 1e-5 relative, the parameters
  within 1e-6 absolute.  A first adamw step moves each parameter by lr x
  g / (|g| + eps), eps = 1e-8: where |g| is below 1e-3 of its leaf's
  largest gradient, the gradient bar no longer bounds that ratio, and
  the parameter is held within 2 lr (counted; a few embedding rows).  A
  crossbar step that misses these bars is excused, as above, only where
  the port's quantizers saw inputs next to a code boundary; it is then
  held with the metrics within 1e-3 relative, the moments within 10 %
  in the Frobenius norm and every parameter within 2 lr.
- remat: "none", "full" and "dots" bit for bit, port against port.
- the attention backward: fp32 within 1e-5 absolute plus relative; bf16
  within one bf16 step at each tensor's largest magnitude (the chunks'
  rounded contributions are summed in other orders).
- the bf16 crossbar kernel path (``dense_apply`` with
  ``XbarMode(use_kernel=True)``): y, dx and dw equal, except where the
  fp32 value lies within 1e-5 relative of a bf16 rounding boundary
  (counted): both sides sum the same exact fp32 products in other orders,
  then round once to bf16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jcfg  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import linear as jlin  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import flash_attention as tfak  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import linear as tlin  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402
from repro_torch.runtime.checkpoint import _key, _walk  # noqa: E402

ARCHS = ["qwen2-0.5b", "yi-6b"]
MODES = {"standard": {},
         "paired": dict(crossbar=True),
         "unpaired": dict(crossbar=True, xbar_paired=False),
         "kernel": dict(crossbar=True, xbar_use_kernel=True)}
NEAR = 1e-4          # a quantizer input this close to a code boundary


def _batch(vocab, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _flat_ref(tree) -> dict[str, np.ndarray]:
    """The reference's leaves keyed as the checkpoints key them."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ref_params(arch, mode):
    jc = jcfg.get_reduced_config(arch, **MODES[mode])
    return jbuild(jc).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch, mode, dtype):
    jc = jcfg.get_reduced_config(arch, compute_dtype=dtype, **MODES[mode])
    jm = jbuild(jc)
    batch = jax.tree.map(jnp.asarray, _batch(jc.vocab_size))
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        _ref_params(arch, mode), batch)
    return float(loss), _flat_ref(grads)


class _NearBoundary:
    """Counts the port's quantizer inputs that lie within NEAR of a code
    boundary (x / scale at a half-integer), in fake_quant and
    error_quantize alike."""

    def __init__(self, monkeypatch):
        self.count = 0
        fq, eq = tq.fake_quant, tq.error_quantize

        def near(x, bits):
            x = x.detach().to(torch.float64)
            scale = x.abs().max() / (2 ** (bits - 1) - 1)
            if float(scale) == 0:
                return
            r = (x / scale).abs()
            self.count += int(((r - torch.floor(r) - 0.5).abs()
                               < NEAR).sum())

        def counted_fq(x, bits, *a, **kw):
            near(x, bits)
            return fq(x, bits, *a, **kw)

        def counted_eq(x, bits=tq.ERROR_BITS, *a, **kw):
            near(x, bits)
            return eq(x, bits, *a, **kw)

        monkeypatch.setattr(tq, "fake_quant", counted_fq)
        monkeypatch.setattr(tq, "error_quantize", counted_eq)


def _port_loss_grads(arch, mode, dtype, **over):
    tc = tcfg.get_reduced_config(arch, compute_dtype=dtype, **MODES[mode],
                                 **over)
    tm = tbuild(tc, "cpu")
    tp = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, _ref_params(arch, mode)), "cpu")
    leaves = tshd.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab_size).items()}
    loss, metrics = tm.loss_fn(tp, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, {_key(path): g for (path, _), g in
                           zip(_walk(tp), grads)}


def _nrel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, mode, dtype, monkeypatch):
    near = _NearBoundary(monkeypatch)
    loss, metrics, grads = _port_loss_grads(arch, mode, dtype)
    loss = loss.detach()
    want_loss, want = _ref_loss_grads(arch, mode, dtype)
    assert float(metrics["aux"]) == 0.0
    assert float(metrics["ce"].detach()) == float(loss)
    assert set(grads) == set(want)
    got = {k: g.to(torch.float32).numpy() for k, g in grads.items()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    if dtype == "float32":
        strict = abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss) \
            and all(np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max()
                    for k, w in want.items())
        if not strict:      # excused only next to a code boundary
            print(f"{arch} {mode}: off the fp32 bar with {near.count} "
                  f"quantizer inputs within {NEAR} of a code boundary")
            assert near.count > 0
            assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)
            for k, w in want.items():
                assert _nrel(got[k], w) <= 0.1, k
    else:
        _, want32 = _ref_loss_grads(arch, mode, "float32")
        assert abs(float(loss) - want_loss) <= 1e-2
        for k, w in want.items():
            noise = _nrel(w, want32[k])
            assert _nrel(got[k], w) <= 1.5 * noise + 1e-6, (k, noise)


def test_wire_mode_trains():
    """The (w, common-mode) reparametrization trains (after the
    reference's tests/test_models_smoke.py::test_crossbar_wire_mode_trains)
    and holds about half the projection parameters of the pair."""
    cfg = tcfg.get_reduced_config("yi-6b", crossbar=True, xbar_paired=False)
    model = tbuild(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg.vocab_size, seed=1).items()}
    leaves = tshd.tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    loss, _ = model.loss_fn(tshd.tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, live)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(0.5 * g)
        loss2, _ = model.loss_fn(params, batch)
    assert float(loss2) < float(loss.detach())
    n_paired = tcfg.get_reduced_config("yi-6b", crossbar=True).param_count()
    assert cfg.param_count() < 0.7 * n_paired


# ---------------------------------------------------------------------------
# make_train_step: one adamw step, with and without microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("mode", ["standard", "kernel"])
def test_train_step_matches_reference(mode, grad_accum, monkeypatch):
    arch = "qwen2-0.5b"
    near = _NearBoundary(monkeypatch)
    jc = jcfg.get_reduced_config(arch, compute_dtype="float32",
                                 **MODES[mode])
    jm = jbuild(jc)
    jp = _ref_params(arch, mode)
    jopt = jadamw(1e-3)
    batch = _batch(jc.vocab_size, B=4, S=32, seed=2)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, grad_accum=grad_accum))
    jnew, jstate, jmet = jstep(jp, jopt.init(jp),
                               jax.tree.map(jnp.asarray, batch), 0)

    tc = tcfg.get_reduced_config(arch, compute_dtype="float32",
                                 **MODES[mode])
    tm = tbuild(tc, "cpu")
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    topt = tadamw(1e-3)
    tstep = ttrain.make_train_step(tm, topt, grad_accum=grad_accum)
    tnew, tstate, tmet = tstep(tp, topt.init(tp),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, 0)
    assert set(tmet) == {"loss", "ce", "aux", "grad_norm"}
    assert float(tmet["aux"]) == 0.0
    assert tnew is tp                       # written in place
    g_ref = {k: m / 0.1 for k, m in _flat_ref(jstate["m"]).items()}
    want = _flat_ref(jnew)
    moments = {m: _flat_ref(jstate[m]) for m in ("m", "v")}

    def check(strict: bool) -> int:
        rtol = 1e-5 if strict else 1e-3
        for k in tmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=rtol, err_msg=k)
        excused = 0
        for path, t in _walk(tnew):
            k = _key(path)
            g = np.abs(g_ref[k])
            small = g <= 1e-3 * g.max() if strict else np.ones_like(g, bool)
            err = np.abs(t.numpy() - want[k])
            assert (err[~small] <= 1e-6).all(), (k, err[~small].max())
            assert (err[small] <= 2e-3 + 1e-6).all(), k
            excused += int((err[small] > 1e-6).sum())
        for m, ref in moments.items():
            for path, t in _walk(tstate[m]):
                w = ref[_key(path)]
                if strict:
                    err = np.abs(t.numpy() - w).max()
                    assert err <= 1e-4 * np.abs(w).max(), (m, _key(path))
                else:
                    assert _nrel(t.numpy(), w) <= 0.1, (m, _key(path))
        return excused

    try:
        excused = check(strict=True)
    except AssertionError:
        # excused only next to a code boundary
        print(f"train step ({mode}, grad_accum {grad_accum}): off the fp32 "
              f"bar with {near.count} quantizer inputs within {NEAR} of a "
              f"code boundary")
        assert mode != "standard" and near.count > 0
        excused = check(strict=False)
    print(f"train step ({mode}, grad_accum {grad_accum}): {excused} "
          f"parameters with |g| below 1e-3 of their leaf's largest moved "
          f"by more than 1e-6 apart")


def test_grad_accum_slices_rows_interleaved():
    """Microbatch i holds rows i, i + k, ... (the reference's slicing), and
    the step's gradient is the mean of theirs."""
    seen = []

    class Spy:
        cfg = None

        @staticmethod
        def loss_fn(params, batch):
            seen.append(batch["tokens"][:, 0].tolist())
            loss = (params["w"] * batch["tokens"].float().mean()).sum()
            return loss, {"ce": loss, "aux": torch.zeros(())}

    from repro_torch.optim import sgd
    step = ttrain.make_train_step(Spy, sgd(0.0, momentum=0.0), grad_accum=3)
    tokens = torch.arange(6, dtype=torch.int32)[:, None].expand(6, 4)
    params = {"w": torch.ones(2)}
    _, _, met = step(params, {}, {"tokens": tokens}, 0)
    assert seen == [[0, 3], [1, 4], [2, 5]]
    assert float(met["loss"]) == pytest.approx(2 * 2.5)
    assert float(met["grad_norm"]) == pytest.approx(2.5 * 2 ** 0.5)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, {}, {"tokens": tokens[:4]}, 0)


# ---------------------------------------------------------------------------
# remat changes no value
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [("standard", "bfloat16"),
                                        ("kernel", "bfloat16"),
                                        ("unpaired", "float32")])
def test_remat_changes_no_value(mode, dtype):
    runs = {r: _port_loss_grads("qwen2-0.5b", mode, dtype, remat=r)
            for r in ("none", "full", "dots")}
    loss, _, grads = runs["none"]
    for r in ("full", "dots"):
        assert torch.equal(runs[r][0], loss), r
        for k, g in grads.items():
            assert torch.equal(runs[r][2][k], g), (r, k)


# ---------------------------------------------------------------------------
# the attention backward: the card's autograd function and its plain VJP
# ---------------------------------------------------------------------------

ATTN_CASES = [(2, 64, 4, 2, 16, 32, 32), (1, 96, 4, 1, 32, 32, 16),
              (2, 64, 4, 4, 16, 64, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_vjp_matches_jax_vjp(case, dtype):
    B, S, H, K, hd, qc, kc = case
    rng = np.random.default_rng(sum(case))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                    (B, S, H, hd)))
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))

    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, scale=hd ** -0.5,
                                       causal=True, window=None, q_chunk=qc,
                                       kv_chunk=kc)

    _, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jd))
    got = tfak.flash_attention_vjp(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        torch.from_numpy(do).to(td), scale=hd ** -0.5, causal=True,
        q_chunk=qc, kv_chunk=kc)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == td
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            step = np.spacing(np.float32(np.abs(w).max())) * 2 ** 16
            assert np.abs(g - w).max() <= step, name


def test_flash_autograd_function_counts_and_differentiates(monkeypatch):
    """The CUDA path's autograd function, with the kernel replaced by its
    plain version (no card here): each forward launches once and counts
    once, and its backward (``flash_attention_vjp``) gives the plain
    function's autograd gradient bit for bit."""
    def plain_kernel(q, k, v, *, scale, causal, semantics, window):
        return tfak.chunked_attention_plain(q, k, v, scale=scale,
                                            causal=causal, q_chunk=16,
                                            kv_chunk=16, window=window)

    monkeypatch.setattr(tfak, "flash_attention_kernel", plain_kernel)
    monkeypatch.setattr(tops.flash_attention, "launches", 0)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16).requires_grad_(True)
               for s in ((2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    do = torch.from_numpy(rng.standard_normal((2, 48, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    out = tops._FlashAttention.apply(q, k, v, 0.25, True, "chunked", 16, 16)
    assert tops.flash_attention.launches == 1
    got = torch.autograd.grad(out, (q, k, v), do)
    assert tops.flash_attention.launches == 1     # the backward launches none
    ref = tfak.chunked_attention_plain(q, k, v, scale=0.25, causal=True,
                                       q_chunk=16, kv_chunk=16)
    assert torch.equal(out, ref)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the bf16 crossbar kernel path (its kernels' operands are cast to fp32)
# ---------------------------------------------------------------------------

def _near_bf16_boundary(v64: np.ndarray) -> np.ndarray:
    """Where a float64 value lies within 1e-5 relative of a bf16 rounding
    boundary (the midpoint of two neighbouring bf16 values)."""
    a = np.abs(v64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7)
    r = a / ulp
    return np.abs(r - np.floor(r) - 0.5) * ulp <= 1e-5 * a


def _bf16_equal_but_boundaries(got, want, exact64, what) -> int:
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    off = got != want
    excused = _near_bf16_boundary(exact64)
    assert not (off & ~excused).any(), (
        what, int((off & ~excused).sum()),
        float(np.abs(got - want)[off & ~excused].max()))
    return int(off.sum())


def test_dense_apply_kernel_mode_bf16_matches_reference():
    """The bf16 crossbar kernel path computes the reference's function: its
    products on the operands' exact fp32 values (G+ - G- subtracted in
    fp32), each result rounded once to bf16."""
    K, N = 96, 80
    rng = np.random.default_rng(5)
    spec = jlin.dense_spec(K, N, ("fsdp", "ff"),
                           xbar=jlin.XbarMode(use_kernel=True))
    jp = jax.tree.map(np.asarray, jax.tree.map(
        lambda s: s.init(jax.random.PRNGKey(3), s.shape, jnp.float32), spec,
        is_leaf=lambda s: hasattr(s, "init")))
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    t = rng.standard_normal((2, 3, N)).astype(np.float32)
    jx, jt = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, t))

    def jf(x, gp, gm):
        return jlin.dense_apply({"g_plus": gp, "g_minus": gm}, x,
                                compute_dtype=jnp.bfloat16,
                                xbar=jlin.XbarMode(use_kernel=True))

    jy, vjp = jax.vjp(jf, jx, jnp.asarray(jp["g_plus"]),
                      jnp.asarray(jp["g_minus"]))
    jdx, jdgp, jdgm = vjp(jt)

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tgp, tgm = (torch.from_numpy(jp[k].copy()).requires_grad_(True)
                for k in ("g_plus", "g_minus"))
    ty = tlin.dense_apply({"g_plus": tgp, "g_minus": tgm}, tx,
                          compute_dtype=torch.bfloat16,
                          xbar=tlin.XbarMode(use_kernel=True))
    tdx, tdgp, tdgm = torch.autograd.grad(
        ty, (tx, tgp, tgm), torch.from_numpy(t).to(torch.bfloat16))
    assert ty.dtype == tdx.dtype == torch.bfloat16
    assert tdgp.dtype == tdgm.dtype == torch.float32

    # the exact fp32 operands, in float64: the quantized input, the pair's
    # bf16 values and their fp32 difference, the error's codes x scale
    xq = tq.fake_quant(tx.detach(), 8).to(torch.float64).numpy()
    w = (tgp.detach().to(torch.bfloat16).float()
         - tgm.detach().to(torch.bfloat16).float()).double().numpy()
    qt = tq.error_quantize(torch.from_numpy(t).to(torch.bfloat16), 8)
    d = (qt.codes.double() * qt.scale.double()).numpy()
    flips = {
        "y": _bf16_equal_but_boundaries(ty.detach(), jy, xq @ w, "y"),
        "dx": _bf16_equal_but_boundaries(tdx, jdx, d @ w.T, "dx"),
        "dw": _bf16_equal_but_boundaries(
            tdgp, jdgp, np.einsum("bmk,bmn->kn", xq, d), "dw"),
    }
    assert torch.equal(tdgm, -tdgp)
    np.testing.assert_array_equal(np.asarray(jdgm, np.float32),
                                  -np.asarray(jdgp, np.float32))
    print(f"bf16 kernel path: values that differ (all within 1e-5 of a "
          f"bf16 rounding boundary): {flips}")
    assert sum(flips.values()) <= 3


def test_crossbar_wrappers_take_bf16_operands():
    """``crossbar_fwd``/``bwd``/``dw`` on bf16 operands equal the same
    wrappers on the operands' fp32 copies, bit for bit (both compute in
    fp32); ``crossbar_matmul`` returns x's dtype and the gradients in the
    operands' dtypes."""
    rng = np.random.default_rng(9)
    x, gp, gm, dy = (torch.from_numpy(rng.uniform(-1, 1, s).astype(
        np.float32)).to(torch.bfloat16) for s in ((5, 24), (24, 12),
                                                   (24, 12), (5, 12)))
    f = [t.float() for t in (x, gp, gm, dy)]
    assert torch.equal(tops.crossbar_fwd(x, gp, gm, activation=False),
                       tops.crossbar_fwd(f[0], f[1], f[2], activation=False))
    assert torch.equal(tops.crossbar_bwd(dy, gp, gm),
                       tops.crossbar_bwd(f[3], f[1], f[2]))
    assert torch.equal(tops.crossbar_dw(x, dy), tops.crossbar_dw(f[0], f[3]))
    xs = x.detach().requires_grad_(True)
    gps, gms = (g.detach().requires_grad_(True) for g in (gp, gm))
    y = tops.crossbar_matmul(xs, gps, gms, error_quant=True)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, (xs, gps, gms), dy)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
