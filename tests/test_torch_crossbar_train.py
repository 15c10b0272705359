"""Port parity: the training half of ``repro_torch.core.crossbar`` — the
``_xbar_matmul`` gradient (8-bit error transport), ``crossbar_apply`` on
the kernel path (``kernels/ops.crossbar_matmul``), ``paper_backprop_step``
and ``paper_backprop_step_scan`` — against ``repro.core.crossbar`` under
``jax.grad`` and its own steps, on the reference's drawn conductances (CPU;
the Pallas kernels in interpret mode, the port's wrappers on their plain
versions).

Tolerances: gradients within 1e-5 absolute and relative (the repo's bar,
``tests/test_kernel_grads.py``); step errors within 1e-6.  Conductances
agree within 1e-6, except where the plain unrounded pulse count
2 lr (a^T local) / (B u) lies within 1e-4 of a half-integer: there one
pulse may round the other way (the port divides by the batch where the
reference does, but sums in another order; the scan step folds 1/B into
lr), so a conductance may differ by u/2 = 1.95e-4 and no more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4

GRAD_SHAPES = [(8, 4, 3), (4, 37, 11), (16, 130, 70),
               (8, 512, 128)]               # tests/test_kernel_grads.py


def _specs(**kw):
    """The same CrossbarSpec in both packages."""
    return jxb.CrossbarSpec(**kw), txb.CrossbarSpec(**kw)


def _kernel_kw(use_kernel):
    """The plain path is the default call (as the recognition slice
    already offered it); the kernel path asks for ``use_kernel``."""
    return {"use_kernel": True} if use_kernel else {}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jax_layers(dims, seed, spec):
    key = jax.random.PRNGKey(seed)
    return [jxb.init_conductances(jax.random.fold_in(key, i), f, o, spec)
            for i, (f, o) in enumerate(zip(dims, dims[1:]))]


def _torch_layers(jl):
    return [{k: torch.tensor(np.asarray(v)) for k, v in p.items()}
            for p in jl]


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, shape).astype(np.float32)


def plain_counts(layers, x, target, spec, lr):
    """The paper rule's unrounded pulse counts per layer (float64), from
    the port's plain math on numpy inputs."""
    acts, dps, h = [], [], torch.from_numpy(x)
    for li, p in enumerate(layers):
        if li > 0 and spec.transport_quant:
            h = tq.adc_quantize(h, spec.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = torch.from_numpy(target) - h
    unit = spec.max_update / spec.update_levels
    B = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        if spec.error_quant:
            delta = tq.error_quantize(delta, spec.err_bits).dequantize()
        local = delta * txb.hard_sigmoid_deriv(dps[li])
        acc = torch.einsum("...i,...j->ij", acts[li].double(),
                           local.double())
        counts[li] = (2.0 * lr * acc / B / unit).numpy()
        delta = local @ (layers[li]["g_plus"] - layers[li]["g_minus"]).T
    return counts


def assert_layers_match(got, want, counts=None, *, pulsed=True):
    """Conductances within G_ATOL; with pulses, cells next to a half-integer
    of the plain ``counts`` may differ by one half pulse."""
    half_u = 0.5 * 0.05 / 128
    for li, (a, b) in enumerate(zip(got, want)):
        near = np.zeros(np.shape(b["g_plus"]), bool)
        if pulsed:
            c = counts[li]
            near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
        for k in ("g_plus", "g_minus"):
            d = np.abs(_np(a[k]) - _np(b[k]))
            assert np.all(d[~near] <= G_ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= half_u + G_ATOL), (li, k)


# ---------------------------------------------------------------------------
# Gradients: _xbar_matmul and crossbar_matmul against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("error_quant", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_crossbar_apply_grads_match_jax(shape, error_quant, use_kernel):
    """torch.autograd through crossbar_apply == jax.grad through the
    reference (tests/test_kernel_grads.py's loss), for x, g+ and g-.  With
    error_quant the backward must quantize the error to 8-bit codes."""
    M, K, N = shape
    sj, st = _specs(transport_quant=False, error_quant=error_quant,
                    update_quant=False)
    p = _jax_layers([K, N], M + K, sj)[0]
    rng = np.random.default_rng(M * K)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)

    def loss(params, x):
        return jnp.sum(jxb.crossbar_apply(params, x, sj) * r)

    gp_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(p, x)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = txb.crossbar_apply(tp, tx, st, **_kernel_kw(use_kernel))
    g = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                            (tx, tp["g_plus"], tp["g_minus"]))
    for got, want in zip(g, (gx_ref, gp_ref["g_plus"], gp_ref["g_minus"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("error_quant", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_crossbar_apply_grads_paper_spec_squared_error(error_quant,
                                                        use_kernel):
    """The paper spec, a 41 -> 15 layer, batch 8, squared-error loss, both
    a network input (DAC) and a transported input (3-bit ADC with STE)."""
    sj = dataclasses.replace(japps.PAPER_SPEC, error_quant=error_quant)
    st = dataclasses.replace(tapps.PAPER_SPEC, error_quant=error_quant)
    p = _jax_layers([41, 15], 7, sj)[0]
    x = _uniform(8, (8, 41))
    t = _uniform(9, (8, 15))
    for transport_in in (False, True):
        def loss(params, x):
            y = jxb.crossbar_apply(params, x, sj, transport_in=transport_in)
            return jnp.sum((y - t) ** 2)

        gp_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(p, x)
        tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in p.items()}
        tx = torch.tensor(x, requires_grad=True)
        y = txb.crossbar_apply(tp, tx, st, transport_in=transport_in,
                               **_kernel_kw(use_kernel))
        g = torch.autograd.grad(((y - torch.from_numpy(t)) ** 2).sum(),
                                (tx, tp["g_plus"], tp["g_minus"]))
        for got, want in zip(g, (gx_ref, gp_ref["g_plus"],
                                 gp_ref["g_minus"])):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("error_quant", [False, True])
def test_crossbar_matmul_grads_match_pallas_path(shape, error_quant):
    """ops.crossbar_matmul's backward (codes + scale into bwd and dw) ==
    the reference's custom VJP over the Pallas kernels, in interpret
    mode."""
    M, K, N = shape
    rng = np.random.default_rng(K + N)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    gp = rng.uniform(0, 0.02, (K, N)).astype(np.float32)
    gm = rng.uniform(0, 0.02, (K, N)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32)

    def loss(x, gp, gm):
        return jnp.sum(jops.crossbar_matmul(x, gp, gm,
                                            error_quant=error_quant) * r)

    want = jax.grad(loss, argnums=(0, 1, 2))(x, gp, gm)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gp, gm)]
    y = tops.crossbar_matmul(*leaves, error_quant=error_quant)
    np.testing.assert_allclose(_np(y), x @ (gp - gm), atol=ATOL, rtol=ATOL)
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL,
                                   rtol=ATOL)
    np.testing.assert_array_equal(_np(got[1]), -_np(got[2]))


def test_use_kernel_falls_through_for_split_activation():
    """Fig.-14 sub-neuron mode is not kernel-fused: use_kernel falls
    through to the split path (tests/test_kernel_grads.py)."""
    sj, st = _specs(rows=100, cols=30, split_activation=True,
                    transport_quant=False)
    p = _jax_layers([250, 20], 13, sj)[0]
    x = (np.random.default_rng(13).standard_normal((4, 250)) * 0.3
         ).astype(np.float32)
    ref = np.asarray(jxb.crossbar_apply(p, x, sj, use_kernel=True))
    tp = _torch_layers([p])[0]
    before = tops.crossbar_fwd.launches
    got = txb.crossbar_apply(tp, torch.from_numpy(x), st, use_kernel=True)
    np.testing.assert_allclose(_np(got), ref, atol=1e-6)
    np.testing.assert_allclose(
        _np(got), _np(txb.crossbar_apply(tp, torch.from_numpy(x), st)),
        atol=1e-6)
    assert tops.crossbar_fwd.launches == before


# ---------------------------------------------------------------------------
# The paper's training rule
# ---------------------------------------------------------------------------

STEP_CASES = {
    # tests/test_kernel_grads.py:120-168 and the paper's kdd network
    "stack_24x3_b16": dict(dims=[24] * 4, B=16, lr=0.7, seed=5,
                           spec=dict(update_quant=True)),
    "stack_20x2_b8_continuous": dict(dims=[20] * 3, B=8, lr=0.7, seed=12,
                                     spec=dict(update_quant=False)),
    "kdd_41_15_41_b2": dict(dims=[41, 15, 41], B=2, lr=0.1, seed=0,
                            spec=dict(update_quant=True)),
    "kdd_single_sample": dict(dims=[41, 15, 41], B=None, lr=0.1, seed=1,
                              spec=dict(update_quant=True)),
    "no_quant": dict(dims=[30, 12, 5], B=4, lr=0.3, seed=2,
                     spec=dict(transport_quant=False, error_quant=False,
                               update_quant=False)),
}


def _step_data(c):
    sj, _ = _specs(**c["spec"])
    jl = _jax_layers(c["dims"], c["seed"], sj)
    lead = (c["B"],) if c["B"] else ()
    x = _uniform(c["seed"] + 10, lead + (c["dims"][0],))
    t = _uniform(c["seed"] + 11, lead + (c["dims"][-1],))
    return jl, x, t


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_paper_backprop_step_matches_reference(name):
    c = STEP_CASES[name]
    sj, st = _specs(**c["spec"])
    jl, x, t = _step_data(c)
    want, want_err = jxb.paper_backprop_step([dict(p) for p in jl], x, t,
                                             sj, lr=c["lr"])
    tl = _torch_layers(jl)
    got, err = txb.paper_backprop_step(tl, torch.from_numpy(x),
                                       torch.from_numpy(t), st, lr=c["lr"])
    np.testing.assert_allclose(_np(err), np.asarray(want_err), atol=G_ATOL)
    assert_layers_match(got, want, plain_counts(tl, x, t, st, c["lr"]),
                        pulsed=st.update_quant)
    # the inputs are not modified
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(_np(a["g_plus"]),
                                      np.asarray(b["g_plus"]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["stack_24x3_b16",
                                  "stack_20x2_b8_continuous"])
def test_scan_step_matches_reference_scan(name, use_kernel):
    """paper_backprop_step_scan == the reference's jitted scan (both
    use_kernel values; pulsed and continuous updates)."""
    c = STEP_CASES[name]
    sj, st = _specs(**c["spec"])
    jl, x, t = _step_data(c)
    want, want_err = jxb.paper_backprop_step_scan(
        jxb.stack_layers(jl), x, t, sj, c["lr"], use_kernel)
    tl = _torch_layers(jl)
    counts = plain_counts(tl, x, t, st, c["lr"])
    stacked = txb.stack_layers(tl)
    got, err = txb.paper_backprop_step_scan(
        stacked, torch.from_numpy(x), torch.from_numpy(t), st, c["lr"],
        use_kernel)
    np.testing.assert_allclose(_np(err), np.asarray(want_err), atol=G_ATOL)
    assert_layers_match(txb.unstack_layers(got), jxb.unstack_layers(want),
                        counts, pulsed=st.update_quant)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("update_quant", [True, False])
def test_scan_step_matches_python_loop(use_kernel, update_quant):
    """The scan step == paper_backprop_step on an equal-shaped stack
    (tests/test_kernel_grads.py), and it writes the stacked conductances
    in place: the returned dict is the argument, its buffers updated."""
    c = STEP_CASES["stack_24x3_b16"]
    st = _specs(**dict(c["spec"], update_quant=update_quant))[1]
    jl, x, t = _step_data(c)
    tl = _torch_layers(jl)
    want, want_err = txb.paper_backprop_step(
        tl, torch.from_numpy(x), torch.from_numpy(t), st, lr=0.7)
    stacked = txb.stack_layers(tl)
    ptrs = {k: v.data_ptr() for k, v in stacked.items()}
    got, err = txb.paper_backprop_step_scan(
        stacked, torch.from_numpy(x), torch.from_numpy(t), st, 0.7,
        use_kernel)
    assert got is stacked
    assert {k: v.data_ptr() for k, v in got.items()} == ptrs
    np.testing.assert_allclose(_np(err), _np(want_err), atol=G_ATOL)
    assert_layers_match(txb.unstack_layers(got), want,
                        plain_counts(tl, x, t, st, 0.7),
                        pulsed=update_quant)


def test_scan_step_runs_the_kernel_wrappers():
    c = STEP_CASES["stack_24x3_b16"]
    st = _specs(**c["spec"])[1]
    jl, x, t = _step_data(c)
    calls = []
    names = ("crossbar_fwd", "crossbar_bwd", "pulse_update", "crossbar_dw")
    orig = {n: getattr(tops, n) for n in names}
    try:
        for n in names:
            setattr(tops, n, (lambda n: lambda *a, **k: (
                calls.append(n), orig[n](*a, **k))[1])(n))
        txb.paper_backprop_step_scan(txb.stack_layers(_torch_layers(jl)),
                                     torch.from_numpy(x),
                                     torch.from_numpy(t), st, 0.7, True)
        txb.paper_backprop_step_scan(
            txb.stack_layers(_torch_layers(jl)), torch.from_numpy(x),
            torch.from_numpy(t), dataclasses.replace(st, update_quant=False),
            0.7, True)
    finally:
        for n in names:
            setattr(tops, n, orig[n])
    assert calls.count("crossbar_fwd") == 6
    assert calls.count("crossbar_bwd") == 6
    assert calls.count("pulse_update") == 3
    assert calls.count("crossbar_dw") == 3


def test_stack_layers_round_trip_and_rejects_ragged():
    jl = _jax_layers([4, 10, 2], 7, jxb.CrossbarSpec())
    with pytest.raises(ValueError):
        txb.stack_layers(_torch_layers(jl))
    tl = _torch_layers(_jax_layers([6, 6, 6], 7, jxb.CrossbarSpec()))
    for a, b in zip(txb.unstack_layers(txb.stack_layers(tl)), tl):
        assert torch.equal(a["g_plus"], b["g_plus"])
        assert torch.equal(a["g_minus"], b["g_minus"])


def test_stochastic_pulse_rounding_takes_a_generator():
    """``generator`` (the reference's ``key``) rounds each pulse count down
    or up: the result is reproducible from the generator's seed, and every
    count lies within one pulse of the nearest-rounded step."""
    c = STEP_CASES["kdd_41_15_41_b2"]
    st = _specs(**c["spec"])[1]
    jl, x, t = _step_data(c)
    tl = _torch_layers(jl)
    args = (torch.from_numpy(x), torch.from_numpy(t), st)
    a, _ = txb.paper_backprop_step(tl, *args, lr=0.3,
                                   generator=torch.Generator().manual_seed(1))
    b, _ = txb.paper_backprop_step(tl, *args, lr=0.3,
                                   generator=torch.Generator().manual_seed(1))
    near, _ = txb.paper_backprop_step(tl, *args, lr=0.3)
    u = st.max_update / st.update_levels
    moved = False
    for pa, pb, pn in zip(a, b, near):
        for k in ("g_plus", "g_minus"):
            assert torch.equal(pa[k], pb[k])
            assert float((pa[k] - pn[k]).abs().max()) <= u / 2 + G_ATOL
            moved |= not torch.equal(pa[k], pn[k])
    assert moved


def test_paper_backprop_reduces_error_step_for_step():
    """Mirror of tests/test_crossbar.py::test_paper_backprop_reduces_error
    (150 steps of the toy mapping under full constraints).  Each port step
    is held to the reference's step from the same conductances, so the
    port follows the reference's math step for step; the error falls and
    the conductances stay in range.  (The reference's own pin, e1 < 0.8 e0,
    is not met by the reference either: see CHANGES.md.)"""
    key = jax.random.PRNGKey(2)
    sj, st = _specs(adc_bits=3, err_bits=8, update_quant=True,
                    max_update=0.02)
    k1, k2, k3 = jax.random.split(key, 3)
    jl = [jxb.init_conductances(k1, 4, 10, sj),
          jxb.init_conductances(k2, 10, 2, sj)]
    x = jax.random.uniform(k3, (64, 4), minval=-0.5, maxval=0.5)
    target = jnp.stack([0.4 * jnp.sign(x[:, 0] * x[:, 1]),
                        -0.4 * jnp.sign(x[:, 2])], axis=1) * 0.5 + 0.0
    xn, tn = np.array(x), np.array(target)
    tx, tt = torch.from_numpy(xn), torch.from_numpy(tn)
    half_u = 0.5 * 0.02 / 128

    def err(layers):
        out = txb.mlp_forward(layers, tx, st, device="cpu")
        return float(((tt - out) ** 2).mean())

    ref = jl
    port = _torch_layers(jl)
    e0 = err(port)
    flips = 0
    for _ in range(150):
        start = _torch_layers(ref)
        got, _ = txb.paper_backprop_step(start, tx, tt, st, lr=1.0)
        ref, _ = jxb.paper_backprop_step(ref, x, target, sj, lr=1.0)
        counts = plain_counts(start, xn, tn, st, 1.0)
        for li, (a, b) in enumerate(zip(got, ref)):
            c = counts[li]
            near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
            for k in ("g_plus", "g_minus"):
                d = np.abs(_np(a[k]) - np.asarray(b[k]))
                assert np.all(d[~near] <= G_ATOL)
                assert np.all(d[near] <= half_u + G_ATOL)
                flips += int((d > G_ATOL).sum())
        port, _ = txb.paper_backprop_step(port, tx, tt, st, lr=1.0)
    e1 = err(port)
    assert e1 < e0, (e0, e1)
    for p in port:
        assert float(p["g_plus"].min()) >= 0
        assert float(p["g_plus"].max()) <= st.w_max + 1e-6
