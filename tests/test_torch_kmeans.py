"""Port parity: the k-means assignment kernel's wrapper
(``repro_torch.kernels.ops.kmeans_assign``, the plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode, its
dispatch, and ``repro_torch.core.kmeans`` against ``repro.core.kmeans`` on
the same numpy inputs and the reference's drawn centers.

Tolerances: distances, sums and centers within 1e-5 absolute plus 1e-5
relative (the repo's kernel bar: the two sides sum over d in different
orders); inertia within 1e-5 relative; counts exact.  Assignments are
equal, except where the two smallest distances of a sample, recomputed in
float64, lie within 1e-5 relative of each other: there a last-bit
difference of the fp32 sums may pick the other center.  Exact ties go to
the lowest index on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kmeans as jkm  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.kernels import kmeans as tkmk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5
NEAR_TIE = 1e-5

# tests/test_kernels.py's shapes, the tile limit, k = 1
ASSIGN_SHAPES = [(64, 4, 3), (1000, 20, 7), (256, 32, 32), (513, 10, 5),
                 (300, 128, 128), (200, 16, 1)]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def near_tie_flips(x, centers, got, want) -> int:
    """Assert ``got`` and ``want`` agree except at near-ties: samples whose
    two smallest float64 distances lie within NEAR_TIE relative, where
    either of the two nearest centers is allowed.  Returns the count."""
    got, want = _np(got).astype(np.int64), _np(want).astype(np.int64)
    off = np.nonzero(got != want)[0]
    if off.size == 0:
        return 0
    d = np.abs(_np(x)[off, None, :].astype(np.float64)
               - _np(centers)[None, :, :].astype(np.float64)).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    gap = (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-30)
    assert np.all(gap <= NEAR_TIE), (off[gap > NEAR_TIE], gap.max())
    rows = np.arange(off.size)
    for a in (got[off], want[off]):
        assert np.all(d[rows, a] <= two[:, 1] * (1 + 1e-12))
    return int(off.size)


def _data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# ops.kmeans_assign (the kernel's wrapper; plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k", ASSIGN_SHAPES)
def test_kmeans_assign_matches_pallas(n, d, k):
    x, c = _data(n, d, k, seed=n + d + k)
    want = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c))
    got = tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (n,)
    near_tie_flips(x, c, got, want)
    near_tie_flips(x, c, tref.kmeans_assign_ref(torch.from_numpy(x),
                                                torch.from_numpy(c)),
                   jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("case", ["duplicated centers", "centers are rows",
                                  "symmetric integer grid"])
def test_kmeans_assign_exact_ties_go_to_the_lowest_index(case):
    rng = np.random.default_rng(7)
    if case == "duplicated centers":
        x, c = _data(400, 12, 5, seed=3)
        c = np.concatenate([c, c[::-1], c])          # every center 3 times
        lowest = {j: min(i for i in range(len(c)) if np.array_equal(
            c[i], c[j])) for j in range(len(c))}
    elif case == "centers are rows":
        x, _ = _data(300, 8, 1, seed=4)
        c = np.concatenate([x[:6], x[:6]])
        lowest = {j: j % 6 for j in range(len(c))}
    else:   # sums of small integers are exact: x = 0 is equidistant
        x = rng.integers(-2, 3, (256, 6)).astype(np.float32)
        x[:64] = 0.0
        c = np.stack([np.full(6, 1.0), np.full(6, -1.0), np.full(6, 1.0),
                      np.zeros(6) + np.eye(6)[0] * 6]).astype(np.float32)
        lowest = {0: 0, 1: 1, 2: 0, 3: 3}
    want = np.asarray(jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    got = _np(tops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c)))
    np.testing.assert_array_equal(got, want)
    assert all(lowest[j] == j for j in np.unique(got))
    if case == "symmetric integer grid":
        assert np.all(got[:64] == 0)        # |0 - 1| * 6 == |0 + 1| * 6


def test_dispatch_counts_only_kernel_launches_and_checks_limits():
    x, c = (torch.from_numpy(a) for a in _data(50, 6, 4, seed=1))
    tops.kmeans_assign.launches = 0
    tops.kmeans_assign(x, c)
    tkm.assign(x, c, use_kernel=True)
    tkm.kmeans_fit(x, c, epochs=2, use_kernel=True)
    assert tops.kmeans_assign.launches == 0      # CPU tensors: plain path
    # fp64 and half inputs are taken as fp32, as the Pallas body casts them
    assert torch.equal(tops.kmeans_assign(x.double(), c.half()),
                       tkmk.kmeans_assign_plain(x, c.half().float()))
    for bad_x, bad_c in ((torch.zeros(5, 129), torch.zeros(3, 129)),
                         (torch.zeros(5, 4), torch.zeros(129, 4)),
                         (torch.zeros(5, 4), torch.zeros(0, 4)),
                         (torch.zeros(5, 4), torch.zeros(3, 5))):
        with pytest.raises(ValueError, match="centers"):
            tops.kmeans_assign(bad_x, bad_c)
    # the kernel launcher takes CUDA tensors only: no CPU fallback there
    with pytest.raises(ValueError, match="CUDA device"):
        tkmk.kmeans_assign_kernel(x, c)
    assert tops.kmeans_assign.launches == 0


def test_tensors_off_the_cpu_go_to_the_kernel_never_to_plain():
    """A tensor that does not lie on the CPU is the kernel's (here a
    ``meta`` tensor: this machine has no card), which raises on anything
    but CUDA tensors; the wrapper never falls back to the plain version
    and counts no launch."""
    x, c = torch.zeros(4, 3, device="meta"), torch.zeros(2, 3, device="meta")
    tops.kmeans_assign.launches = 0
    for fn in (lambda: tops.kmeans_assign(x, c),
               lambda: tkm.assign(x, c, use_kernel=True)):
        with pytest.raises(ValueError, match="CUDA device"):
            fn()
    assert tops.kmeans_assign.launches == 0


# ---------------------------------------------------------------------------
# core.kmeans
# ---------------------------------------------------------------------------

def _close(got, want, rtol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=TOL)


@pytest.mark.parametrize("n,d,k", [(300, 16, 4), (1000, 20, 10)])
def test_distances_accumulate_and_update(n, d, k):
    x, c = _data(n, d, k, seed=11)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    _close(tkm.manhattan_distances(tx, tc), jkm.manhattan_distances(jx, jc))
    a = np.array(jkm.assign(jx, jc))
    a[a == k - 1] = 0                  # leave the last cluster empty
    sums, counts = jkm.accumulate(jx, jnp.asarray(a), k)
    tsums, tcounts = tkm.accumulate(tx, torch.from_numpy(a), k)
    _close(tsums, sums)
    np.testing.assert_array_equal(_np(tcounts), np.asarray(counts))
    assert float(tcounts[-1]) == 0
    new = tkm.update_centers(tsums, tcounts, tc)
    _close(new, jkm.update_centers(sums, counts, jc))
    np.testing.assert_array_equal(_np(new[-1]), c[-1])   # kept, not zeroed


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_fit_matches_reference(use_kernel):
    """kmeans_fit from the reference's k-means++ centers: centers, inertia
    and the final assignment after 15 epochs.  No assignment flipped at a
    near-tie on these inputs, so the whole fit is compared at once (a flip
    would call for comparing epoch by epoch from the reference's centers;
    the assertion below would show it)."""
    key = jax.random.PRNGKey(7)
    x, _ = jsyn.gaussian_mixture(key, 512, dim=16, k=4, spread=2.0,
                                 noise=0.15)
    init = jkm.init_plusplus(jax.random.PRNGKey(8), x, 4)
    centers, a, inertia = jkm.kmeans_fit(x, init, epochs=15,
                                         use_kernel=use_kernel)
    tx, ti = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(init))
    tcenters, ta, tinertia = tkm.kmeans_fit(tx, ti, epochs=15,
                                            use_kernel=use_kernel)
    _close(tcenters, centers)
    np.testing.assert_allclose(_np(tinertia), np.asarray(inertia),
                               rtol=TOL)
    assert ta.dtype == torch.int32
    assert near_tie_flips(x, centers, ta, a) == 0


def test_kmeans_fit_epoch_by_epoch_on_features():
    """A wider fit (n=1000, d=20, k=10, the clustering path's feature width
    and cluster count): each epoch from the reference's centers, so a
    near-tie flip in one epoch cannot carry into the next."""
    x, _ = _data(1000, 20, 1, seed=5)
    x = np.tanh(x) * 0.5
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    centers = jkm.init_plusplus(jax.random.PRNGKey(3), jx, 10)
    flips = 0
    for _ in range(8):
        nxt, a, inertia = jkm.kmeans_fit(jx, centers, epochs=1)
        tn, ta, ti = tkm.kmeans_fit(tx, torch.from_numpy(
            np.array(centers)), epochs=1, use_kernel=True)
        flips += near_tie_flips(x, nxt, ta, a)
        _close(tn, nxt)
        np.testing.assert_allclose(_np(ti), np.asarray(inertia), rtol=TOL)
        centers = nxt
    print(f"near-tie flips over 8 epochs: {flips}")


def test_init_plusplus_weights_follow_the_reference_draws():
    """Given the reference's drawn indices (recovered as the rows of x its
    centers are), the port's k-means++ weights at each draw equal the
    reference's within 1e-6, and each drawn row has weight > 0."""
    key = jax.random.PRNGKey(8)
    x, _ = jsyn.gaussian_mixture(jax.random.PRNGKey(7), 512, dim=16, k=4,
                                 spread=2.0, noise=0.15)
    xn = np.array(x)
    centers = np.asarray(jkm.init_plusplus(key, x, 6))
    idx = [int(np.nonzero((xn == c).all(1))[0][0]) for c in centers]
    tx = torch.from_numpy(xn)
    for i in range(1, len(idx)):
        d = jkm.manhattan_distances(x, x[jnp.asarray(idx[:i])]).min(axis=1)
        want = np.asarray(d / jnp.maximum(d.sum(), 1e-9))
        got = _np(tkm.plusplus_weights(tx, tx[idx[:i]]))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got[idx[i]] > 0
        assert np.all(got[idx[:i]] == 0)


@pytest.mark.parametrize("init", ["init_plusplus", "init_from_data"])
def test_port_seeding_draws_rows_reproducibly(init):
    x, _ = _data(300, 8, 1, seed=9)
    tx = torch.from_numpy(x)
    fn = getattr(tkm, init)
    a = _np(fn(torch.Generator().manual_seed(1), tx, 7))
    b = _np(fn(torch.Generator().manual_seed(1), tx, 7))
    c = _np(fn(torch.Generator().manual_seed(2), tx, 7))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    rows = [np.nonzero((x == r).all(1))[0] for r in a]
    assert all(len(r) == 1 for r in rows)
    assert len({int(r[0]) for r in rows}) == 7        # distinct rows


def test_init_plusplus_when_every_row_is_a_center():
    x = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    got = tkm.init_plusplus(torch.Generator().manual_seed(0), x, 3)
    want = jkm.init_plusplus(jax.random.PRNGKey(0), jnp.asarray(_np(x)), 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
