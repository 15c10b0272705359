"""Port parity: the paper apps — ``repro_torch.data.synthetic``,
``repro_torch.core.autoencoder`` and ``repro_torch.core.anomaly`` — against
``repro.data.synthetic``, ``repro.core.autoencoder`` and
``repro.core.anomaly``, plus the port mirrors of
``tests/test_paper_claims.py``'s paper-app claims and a CPU run of
``examples/torch_clustering_pipeline.py``.

The port draws from a ``torch.Generator`` where the reference draws from
``jax.random``, so the training tests recompute the reference's draws
(initial conductances, one permutation per epoch) from its keys, split as
the reference splits them, and hand them to the port's deterministic bodies
(``*_from``).  Step for step: before each paper backprop step inside a
body, the port's conductances and batch are put back to the reference's
(``Reseeded``), so a pulse that rounds the other way in one step cannot
carry into the next, and each step is held against the reference's.

Tolerances (those of ``tests/test_torch_crossbar_train.py``): conductances
within 1e-6, except where the plain unrounded pulse count lies within 1e-4
of a half-integer, where one pulse may round the other way (u/2 =
1.95e-4); step errors and losses within 1e-6; reconstruction errors within
1e-5; rates, detection and AUC within 1e-6.  The threshold sweep differs
by construction: ``torch.linspace`` and ``jnp.linspace`` round differently
(up to 2 ulp apart), so thresholds agree within 2 ulp and the rates agree
as counts except at a threshold that a score lies within 2 ulp of.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import anomaly as jan  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.core import crossbar as jxb  # noqa: E402
from repro.core import kmeans as jkm  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import anomaly as tan  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
JSPEC, TSPEC = japps.PAPER_SPEC, tapps.PAPER_SPEC
_jstep = jax.jit(jxb.paper_backprop_step, static_argnums=(3, 4))
_PORT_STEP = txb.paper_backprop_step


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.array(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tl(layers):
    return [{k: _t(v) for k, v in p.items()} for p in layers]


# ---------------------------------------------------------------------------
# data.synthetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_classes,lo,hi",
                         [(3, -0.4, 0.4), (10, -0.3, 0.45)])
def test_labeled_targets_exact(n_classes, lo, hi):
    labels = np.random.default_rng(0).integers(0, n_classes, 97)
    want = jsyn.labeled_targets(jnp.asarray(labels), n_classes, lo, hi)
    got = tsyn.labeled_targets(torch.from_numpy(labels), n_classes, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


GENERATORS = {
    "gaussian_mixture": (lambda g: tsyn.gaussian_mixture(
        g, 300, 8, 5, spread=1.5, noise=0.3, data_range=0.4, device="cpu"),
        (300, 8), 5, 0.4),
    "iris_like": (lambda g: tsyn.iris_like(g, device="cpu"), (150, 4), 3,
                  0.5),
    "mnist_like": (lambda g: tsyn.mnist_like(g, 64, device="cpu"),
                   (64, 784), 10, 0.5),
    "isolet_like": (lambda g: tsyn.isolet_like(g, 64, device="cpu"),
                    (64, 617), 26, 0.5),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_contract(name):
    make, shape, k, data_range = GENERATORS[name]
    x, labels = make(torch.Generator().manual_seed(0))
    assert x.shape == shape and x.dtype == torch.float32
    assert labels.shape == shape[:1] and not labels.is_floating_point()
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    assert abs(float(x.abs().max()) - data_range) <= 1e-6
    x2, labels2 = make(torch.Generator().manual_seed(0))
    x3, _ = make(torch.Generator().manual_seed(1))
    assert torch.equal(x, x2) and torch.equal(labels, labels2)
    assert not torch.equal(x, x3)


def test_kdd_like_shares_one_frame():
    normal, attack = tsyn.kdd_like(torch.Generator().manual_seed(0), 256, 64,
                                   device="cpu")
    assert normal.shape == (256, 41) and attack.shape == (64, 41)
    top = max(float(normal.abs().max()), float(attack.abs().max()))
    assert abs(top - 0.5) <= 1e-6
    # the attack families sit off the tight normal clusters in that frame
    assert float(attack.abs().mean()) > 2 * float(normal.abs().mean())
    again = tsyn.kdd_like(torch.Generator().manual_seed(0), 256, 64,
                          device="cpu")
    assert torch.equal(normal, again[0]) and torch.equal(attack, again[1])


def test_entry_points_default_to_cuda_and_refuse_a_missing_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for fn in (lambda: tsyn.iris_like(gen),          # default: cuda
               lambda: tsyn.kdd_like(gen, 8, 4),
               lambda: tae.init_mlp(gen, [4, 3], TSPEC)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


# ---------------------------------------------------------------------------
# Step-for-step machinery
# ---------------------------------------------------------------------------

def pulse_counts(layers, x, target, lr):
    """The paper rule's unrounded pulse counts per layer (float64), from the
    port's plain math on the reference's inputs."""
    acts, dps, h = [], [], _t(x)
    for li, p in enumerate(layers):
        if li > 0:
            h = tq.adc_quantize(h, TSPEC.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = _t(target) - h
    unit = TSPEC.max_update / TSPEC.update_levels
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        delta = tq.error_quantize(delta, TSPEC.err_bits).dequantize()
        local = delta * txb.hard_sigmoid_deriv(dps[li])
        acc = acts[li].double().T @ local.double()
        counts[li] = (2.0 * lr * acc / x.shape[0] / unit).numpy()
        delta = local @ (layers[li]["g_plus"] - layers[li]["g_minus"]).T
    return counts


def ref_chain(layers, x, target, perms, batch, lr):
    """The reference's own steps along ``perms``: (layers in, x, target,
    layers out, error) per step."""
    steps = []
    n = x.shape[0]
    for perm in perms:
        for idx in np.asarray(perm)[: (n // batch) * batch].reshape(
                -1, batch):
            xb, tb = x[idx], target[idx]
            new, err = _jstep(layers, xb, tb, JSPEC, lr)
            steps.append((layers, xb, tb, new, err))
            layers = new
    return steps


class Reseeded:
    """Stands in for the port's ``paper_backprop_step`` inside a body: the
    body's batch must be the reference's; the step runs from the
    reference's conductances and is held against the reference's step."""

    def __init__(self, steps):
        self.steps, self.t, self.flips = steps, 0, 0

    def __call__(self, layers, x, target, spec, lr, generator=None):
        lin, xb, tb, lout, err = self.steps[self.t]
        self.t += 1
        np.testing.assert_array_equal(_np(x), np.asarray(xb))
        np.testing.assert_array_equal(_np(target), np.asarray(tb))
        start = _tl(lin)
        got, gerr = _PORT_STEP(start, x, target, spec, lr, generator)
        np.testing.assert_allclose(_np(gerr), np.asarray(err), atol=G_ATOL)
        half_u = 0.5 * spec.max_update / spec.update_levels
        for c, a, b in zip(pulse_counts(start, np.asarray(xb),
                                         np.asarray(tb), lr), got, lout):
            near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
            for k in ("g_plus", "g_minus"):
                d = np.abs(_np(a[k]) - np.asarray(b[k]))
                assert np.all(d[~near] <= G_ATOL), (self.t, k)
                assert np.all(d[near] <= half_u + G_ATOL), (self.t, k)
                self.flips += int((d > G_ATOL).sum())
        return got, gerr


def ref_pair_draws(key, n, fan_in, hidden, epochs):
    """``repro.core.autoencoder.pretrain_layer``'s draws, split as it
    splits them: (enc, dec, one permutation per epoch)."""
    kenc, kdec = jax.random.split(key)
    enc = jxb.init_conductances(kenc, fan_in, hidden, JSPEC)
    dec = jxb.init_conductances(kdec, hidden, fan_in, JSPEC)
    perms = [jax.random.permutation(k, n)
             for k in jax.random.split(kdec, epochs)]
    return enc, dec, perms


def assert_layers_close(got, want):
    for a, b in zip(got, want):
        for k in ("g_plus", "g_minus"):
            np.testing.assert_allclose(_np(a[k]), np.asarray(b[k]),
                                       atol=G_ATOL)


# ---------------------------------------------------------------------------
# core.autoencoder
# ---------------------------------------------------------------------------

def test_pretrain_layer_step_for_step(monkeypatch):
    normal, _ = jsyn.kdd_like(jax.random.PRNGKey(3), 64, 16)
    key = jax.random.PRNGKey(4)
    enc, dec, perms = ref_pair_draws(key, 64, 41, 15, epochs=2)
    steps = ref_chain([enc, dec], normal, normal, perms, 16, 0.03)
    renc, rdec, rlosses = jae.pretrain_layer(key, normal, 41, 15, JSPEC,
                                             lr=0.03, epochs=2, batch=16)
    # the recomputed draws are the reference's: its chain ends where it does
    assert_layers_close(steps[-1][3], [renc, rdec])
    rs = Reseeded(steps)
    monkeypatch.setattr(txb, "paper_backprop_step", rs)
    tenc, tdec, tlosses = tae.pretrain_layer_from(
        *_tl([enc, dec]), _t(normal), [_t(p) for p in perms], TSPEC,
        lr=0.03, batch=16)
    assert rs.t == len(steps) == 8
    np.testing.assert_allclose(_np(tlosses), np.asarray(rlosses),
                               atol=G_ATOL)
    assert tenc["g_plus"].shape == (41, 15) and tdec["g_plus"].shape == (
        15, 41)


def test_pretrain_stack_step_for_step(monkeypatch):
    x, _ = jsyn.gaussian_mixture(jax.random.PRNGKey(5), 48, dim=16, k=3,
                                 spread=2.0, noise=0.2)
    key = jax.random.PRNGKey(6)
    dims, epochs, batch, lr = [16, 8, 4], 2, 8, 0.05
    renc, rcurves = jae.pretrain_stack(key, x, dims, JSPEC, lr=lr,
                                       epochs=epochs, batch=batch)
    draws, steps, repr_x = [], [], x
    for li, (k, (fi, h)) in enumerate(zip(jax.random.split(key, 2),
                                          zip(dims, dims[1:]))):
        enc, dec, perms = ref_pair_draws(k, 48, fi, h, epochs)
        chain = ref_chain([enc, dec], repr_x, repr_x, perms, batch, lr)
        assert_layers_close(chain[-1][3][:1], [renc[li]])
        draws.append((*_tl([enc, dec]), [_t(p) for p in perms]))
        steps += chain
        repr_x = jxb.q.adc_quantize_ste(
            jxb.crossbar_apply(renc[li], repr_x, JSPEC, transport_in=False),
            JSPEC.adc_bits)
    rs = Reseeded(steps)
    monkeypatch.setattr(txb, "paper_backprop_step", rs)
    tenc, tcurves = tae.pretrain_stack_from(_t(x), draws, TSPEC, lr=lr,
                                            batch=batch)
    assert rs.t == len(steps) == 24
    assert len(tenc) == 2 and len(tcurves) == 2
    for a, b in zip(tcurves, rcurves):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=G_ATOL)


def test_finetune_supervised_step_for_step(monkeypatch):
    x, labels = jsyn.iris_like(jax.random.PRNGKey(0), n=60)
    y = jsyn.labeled_targets(labels, 3)
    layers = jae.init_mlp(jax.random.PRNGKey(1), [4, 10, 3], JSPEC)
    key, epochs = jax.random.PRNGKey(2), 2
    perms = [jax.random.permutation(k, 60)
             for k in jax.random.split(key, epochs)]
    steps = ref_chain(layers, x, y, perms, 10, 1.0)
    rlayers, rcurve = jae.finetune_supervised(key, layers, x, y, JSPEC,
                                              lr=1.0, epochs=epochs,
                                              batch=10)
    assert_layers_close(steps[-1][3], rlayers)
    rs = Reseeded(steps)
    monkeypatch.setattr(txb, "paper_backprop_step", rs)
    tlayers, tcurve = tae.finetune_supervised_from(
        _tl(layers), _t(x), _t(y), [_t(p) for p in perms], TSPEC, lr=1.0,
        batch=10)
    assert rs.t == len(steps) == 12 and len(tlayers) == 2
    np.testing.assert_allclose(_np(tcurve), np.asarray(rcurve), atol=G_ATOL)


def test_generator_entry_points_are_their_bodies_on_the_draws():
    """``pretrain_layer``/``pretrain_stack``/``finetune_supervised`` are
    their ``*_from`` bodies on the generator's draws (encoder, decoder,
    then one permutation per epoch), reproducible per seed."""
    x, labels = tsyn.iris_like(torch.Generator().manual_seed(0), 48,
                               device="cpu")
    y = tsyn.labeled_targets(labels, 3)
    kw = dict(lr=0.05, batch=8)
    enc, dec, losses = tae.pretrain_layer(torch.Generator().manual_seed(1),
                                          x, 4, 2, TSPEC, epochs=2, **kw)
    g = torch.Generator().manual_seed(1)
    draws = [txb.init_conductances(4, 2, TSPEC, generator=g, device="cpu"),
             txb.init_conductances(2, 4, TSPEC, generator=g, device="cpu"),
             [torch.randperm(48, generator=g) for _ in range(2)]]
    want = tae.pretrain_layer_from(*draws[:2], x, draws[2], TSPEC, **kw)
    for a, b in zip((enc, dec), want[:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(losses, want[2]) and losses.shape == (2,)
    stack, curves = tae.pretrain_stack(torch.Generator().manual_seed(1), x,
                                       [4, 2], TSPEC, epochs=2, **kw)
    assert all(torch.equal(stack[0][k], enc[k]) for k in enc)
    assert torch.equal(curves[0], losses)
    layers = tae.init_mlp(torch.Generator().manual_seed(2), [4, 6, 3], TSPEC,
                          device="cpu")
    ft = [tae.finetune_supervised(torch.Generator().manual_seed(3), layers,
                                  x, y, TSPEC, epochs=2, **kw)
          for _ in range(2)]
    assert torch.equal(ft[0][1], ft[1][1]) and ft[0][1].shape == (2,)


# ---------------------------------------------------------------------------
# core.anomaly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kdd_ae():
    """The reference's anomaly-detection setup
    (``tests/test_paper_claims.py::test_anomaly_detection_rate``): data,
    the draws of ``pretrain_layer(PRNGKey(6), ...)`` and its trained
    41 -> 15 -> 41 autoencoder."""
    normal, attack = jsyn.kdd_like(jax.random.PRNGKey(4), n_normal=1024,
                                   n_attack=256)
    key = jax.random.PRNGKey(6)
    draws = ref_pair_draws(key, 1024, 41, 15, epochs=20)
    enc, dec, _ = jae.pretrain_layer(key, normal, 41, 15, JSPEC, lr=0.03,
                                     epochs=20, batch=16)
    return normal, attack, draws, [enc, dec]


def test_reconstruction_error_matches(kdd_ae):
    normal, attack, _, layers = kdd_ae
    for x in (normal, attack):
        want = jan.reconstruction_error(layers, x, JSPEC)
        got = tan.reconstruction_error(_tl(layers), _t(x), TSPEC)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def _ulp_near(scores, ts, ulps=2):
    """Per threshold: does a score lie within ``ulps`` ulp of it?"""
    gap = np.abs(scores[None, :] - ts[:, None])
    return (gap <= ulps * np.spacing(np.abs(ts))[:, None]).any(axis=1)


def test_detection_curve_auc_and_operating_point(kdd_ae):
    normal, attack, _, layers = kdd_ae
    s_n = np.asarray(jan.reconstruction_error(layers, normal, JSPEC))
    s_a = np.asarray(jan.reconstruction_error(layers, attack, JSPEC))
    ts, det, fpr = jan.detection_curve(jnp.asarray(s_n), jnp.asarray(s_a))
    tts, tdet, tfpr = tan.detection_curve(_t(s_n), _t(s_a))
    ts, tts = np.asarray(ts), _np(tts)
    assert tts.shape == (200,) and tts.dtype == np.float32
    # jnp.linspace and torch.linspace round differently: 2 ulp apart at most
    assert np.all(np.abs(tts - ts) <= 2 * np.spacing(np.abs(ts)))
    for scores, n, got, want in ((s_a, len(s_a), tdet, det),
                                 (s_n, len(s_n), tfpr, fpr)):
        cg = np.rint(_np(got) * n).astype(int)
        cw = np.rint(np.asarray(want) * n).astype(int)
        near = _ulp_near(scores, ts)
        np.testing.assert_array_equal(cg[~near], cw[~near])
    for max_fpr in (0.01, 0.04, 0.05):
        assert abs(tan.detection_at_fpr(_t(s_n), _t(s_a), max_fpr)
                   - jan.detection_at_fpr(s_n, s_a, max_fpr)) <= 1e-6
    assert abs(tan.auc(_t(s_n), _t(s_a)) - jan.auc(s_n, s_a)) <= 1e-6
    tied = np.concatenate([s_n[:40], s_a[:40]])   # exact ties count half
    assert abs(tan.auc(_t(s_n), _t(tied)) - jan.auc(s_n, tied)) <= 1e-6


# ---------------------------------------------------------------------------
# Port mirrors of tests/test_paper_claims.py (paper section VI), on the
# reference's data arrays and draws
# ---------------------------------------------------------------------------

def test_supervised_training_converges():
    """Mirror of the reference's iris 4 -> 10 -> 3 claim (acc > 0.85),
    which the reference itself does not meet on this tree (CHANGES.md
    records both accuracies).  The port is held to the reference's math:
    the same draws give the same accuracy, within two of 150 samples."""
    x, labels = jsyn.iris_like(jax.random.PRNGKey(0), n=150)
    y = jsyn.labeled_targets(labels, 3)
    layers = jae.init_mlp(jax.random.PRNGKey(1), [4, 10, 3], JSPEC)
    key = jax.random.PRNGKey(2)
    rlayers, _ = jae.finetune_supervised(key, layers, x, y, JSPEC, lr=1.0,
                                         epochs=150, batch=10)
    acc_ref = float((jnp.argmax(jxb.mlp_forward(rlayers, x, JSPEC), -1)
                     == labels).mean())
    perms = [_t(jax.random.permutation(k, 150))
             for k in jax.random.split(key, 150)]
    tlayers, _ = tae.finetune_supervised_from(_tl(layers), _t(x), _t(y),
                                              perms, TSPEC, lr=1.0,
                                              batch=10)
    out = txb.mlp_forward(tlayers, _t(x), TSPEC, device="cpu")
    acc = float((_np(out.argmax(-1)) == np.asarray(labels)).mean())
    assert abs(acc - acc_ref) <= 2 / 150, (acc, acc_ref)


def test_autoencoder_separates_classes():
    """Paper VI.B: the 4 -> 2 -> 4 autoencoder's hidden space clusters the
    iris classes (between-class distance above within-class spread)."""
    x, labels = jsyn.iris_like(jax.random.PRNGKey(2), n=150)
    key = jax.random.PRNGKey(3)
    draws = [(*_tl(d[:2]), [_t(p) for p in d[2]]) for d in [
        ref_pair_draws(jax.random.split(key, 1)[0], 150, 4, 2, 30)]]
    enc_layers, curves = tae.pretrain_stack_from(_t(x), draws, TSPEC,
                                                 lr=0.05, batch=8)
    assert float(curves[0][-1]) < float(curves[0][0])
    feats = _np(tae.encode(enc_layers, _t(x), TSPEC))
    lab = np.asarray(labels)
    centers = np.stack([feats[lab == c].mean(0) for c in range(3)])
    within = np.mean([np.abs(feats[lab == c] - centers[c]).sum(-1).mean()
                      for c in range(3)])
    between = np.abs(centers[:, None] - centers[None]).sum(-1)
    assert between[np.triu_indices(3, 1)].mean() > within


def test_anomaly_detection_rate(kdd_ae):
    """Paper VI.C / Fig. 20: >= 90% detection at <= 5% FPR and AUC >= 0.95
    on the KDD emulation, the port's 41 -> 15 -> 41 autoencoder trained on
    the reference's draws, and close to the reference's own numbers."""
    normal, attack, (enc, dec, perms), ref_layers = kdd_ae
    tenc, tdec, _ = tae.pretrain_layer_from(
        *_tl([enc, dec]), _t(normal), [_t(p) for p in perms], TSPEC,
        lr=0.03, batch=16)
    s_n = tan.reconstruction_error([tenc, tdec], _t(normal), TSPEC)
    s_a = tan.reconstruction_error([tenc, tdec], _t(attack), TSPEC)
    auc, det = tan.auc(s_n, s_a), tan.detection_at_fpr(s_n, s_a, 0.05)
    assert auc >= 0.95, auc
    assert det >= 0.90, det
    r_n = jan.reconstruction_error(ref_layers, normal, JSPEC)
    r_a = jan.reconstruction_error(ref_layers, attack, JSPEC)
    assert abs(auc - jan.auc(r_n, r_a)) <= 0.01
    assert abs(det - jan.detection_at_fpr(r_n, r_a, 0.05)) <= 0.02


def test_kmeans_recovers_clusters():
    """The clustering pipeline: k-means from the reference's k-means++
    centers finds the generative clusters (purity >= 0.9), inertia never
    rising (within 1e-3), on the kernel route."""
    x, labels = jsyn.gaussian_mixture(jax.random.PRNGKey(7), 512, dim=16,
                                      k=4, spread=2.0, noise=0.15)
    init = jkm.init_plusplus(jax.random.PRNGKey(8), x, 4)
    _, assign, inertia = tkm.kmeans_fit(_t(x), _t(init), epochs=15,
                                        use_kernel=True)
    assert (np.diff(_np(inertia)) <= 1e-3).all()
    a, lab = _np(assign), np.asarray(labels)
    purity = sum(np.max(np.bincount(lab[a == c], minlength=4))
                 for c in range(4) if (a == c).any()) / len(lab)
    assert purity >= 0.9, purity


def test_constraint_accuracy_gap_small():
    """Fig. 21: 3-bit outputs + 8-bit errors cost only a small accuracy gap
    against the unconstrained float implementation (< 10 points)."""
    x, labels = jsyn.iris_like(jax.random.PRNGKey(9), n=150)
    y = jsyn.labeled_targets(labels, 3)
    perms = [_t(jax.random.permutation(k, 150))
             for k in jax.random.split(jax.random.PRNGKey(11), 150)]

    def train_acc(jspec, tspec):
        layers = jae.init_mlp(jax.random.PRNGKey(10), [4, 10, 3], jspec)
        tl, _ = tae.finetune_supervised_from(_tl(layers), _t(x), _t(y),
                                             perms, tspec, lr=1.0, batch=10)
        out = txb.mlp_forward(tl, _t(x), tspec, device="cpu")
        return float((_np(out.argmax(-1)) == np.asarray(labels)).mean())

    acc_c = train_acc(japps.PAPER_SPEC, tapps.PAPER_SPEC)
    acc_f = train_acc(japps.FLOAT_SPEC, tapps.FLOAT_SPEC)
    assert acc_f - acc_c < 0.10, (acc_f, acc_c)


# ---------------------------------------------------------------------------
# The example, on the CPU at a reduced size
# ---------------------------------------------------------------------------

def test_clustering_pipeline_example_runs_on_cpu(capsys):
    path = REPO / "examples" / "torch_clustering_pipeline.py"
    spec = importlib.util.spec_from_file_location("torch_clustering", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.run(device="cpu", seed=0, samples=160, n_normal=256,
                n_attack=64)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith(" purity=") for line in lines)
    assert lines[-1].startswith(" detection at 4% FPR:")
    assert "(paper: 96.6%)" in lines[-1]
