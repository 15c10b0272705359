"""The k-means assignment kernel's tiles (``csrc/kmeans_assign.cu``) from
the CPU: its tile table and the wrapper's choice, each tile's shared memory
and block, the checks the launcher makes before a launch, and the
chain-order plain version (``kernels/kmeans.kmeans_assign_chain``: every
distance summed over ascending features in fp32, then ``argmin``), which
the kernel equals exactly on the card.

Here the chain-order version is held against the reference's Pallas kernel
(interpret mode) at every shape ``chip_smoke.py`` runs the kernel at:
assignments equal, except where the two smallest distances of a sample,
recomputed in float64, lie within 1e-5 relative of each other (the Pallas
body sums over d in XLA's order, so a last-bit difference may pick the
other center there); those samples are counted.  Exact ties go to the
lowest index.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import kmeans as kmk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

NEAR_TIE = 1e-5
SMEM = 227 * 1024          # a block's shared memory on an H100
ROOT = pathlib.Path(__file__).resolve().parents[1]
TILES = range(len(kmk.KMEANS_TILES))


def _smoke_cases():
    """(n, d, k, what) of chip_smoke.py's k-means phase."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.KMEANS_CASES


CASES = _smoke_cases()


def _source_tiles():
    text = (_build.CSRC / "kmeans_assign.cu").read_text()
    body = text.split("#define KMEANS_TILES(X)")[1].split("\n\n")[0]
    rows = re.findall(r"X\((\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\)",
                      body)
    assert [int(r[0]) for r in rows] == list(range(len(rows)))
    return tuple(tuple(int(v) for v in r[1:]) for r in rows)


def _data(n, d, k, what, seed):
    """The smoke's inputs for a case, drawn with numpy: uniform samples and
    centers, or (duplicated centers) 10 samples repeated 3 times."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32)
    if what.startswith("duplicated"):
        return x, np.tile(x[:10], (3, 1))
    return x, rng.uniform(-0.5, 0.5, (k, d)).astype(np.float32)


def near_tie_flips(x, c, got, want) -> int:
    """Assert equal assignments except at near-ties (either of the two
    nearest centers allowed there); returns the count."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    off = np.nonzero(got != want)[0]
    if off.size == 0:
        return 0
    dist = np.abs(x[off, None, :].astype(np.float64)
                  - c[None, :, :].astype(np.float64)).sum(-1)
    two = np.sort(dist, axis=1)[:, :2]
    gap = (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-30)
    assert np.all(gap <= NEAR_TIE), (off[gap > NEAR_TIE], gap.max())
    rows = np.arange(off.size)
    for a in (got[off], want[off]):
        assert np.all(dist[rows, a] <= two[:, 1] * (1 + 1e-12))
    return int(off.size)


# ---------------------------------------------------------------------------
# Tile table, choice and geometry
# ---------------------------------------------------------------------------

def test_tile_table_is_the_sources():
    """The wrapper's table indexes the kernel's instances: it must be
    KMEANS_TILES of kmeans_assign.cu, row for row."""
    assert kmk.KMEANS_TILES == _source_tiles()


def test_chunk_is_the_sources():
    text = (_build.CSRC / "kmeans_assign.cu").read_text()
    assert f"constexpr int DC = {kmk.CHUNK};" in text


@pytest.mark.parametrize("tile", TILES)
def test_tile_geometry_and_shared_memory(tile):
    """A block is whole warps, a sample group's NJ threads are lanes of one
    warp (NJ divides 32; the shuffles combine them), its two chunk buffers
    fit a block's shared memory and the register tile reads whole 16-byte
    vectors."""
    ts, tj, ns, nj = kmk.KMEANS_TILES[tile]
    bs, bk, threads = kmk.kmeans_tile_dims(tile)
    assert (bs, bk, threads) == (ts * ns, tj * nj, ns * nj)
    assert threads % 32 == 0 and threads <= 1024 and 32 % nj == 0
    assert kmk.kmeans_smem(tile) == 2 * (bs + bk) * (kmk.CHUNK + 4) * 4
    assert kmk.kmeans_smem(tile) <= SMEM
    assert (kmk.CHUNK + 4) % 8 == 4          # 8 rows, 8 distinct banks


def test_picks_are_valid_for_every_case_and_limit():
    """Every case of chip_smoke.py and every 1 <= k, d <= 128 (at small and
    large n) takes a tile of the table."""
    shapes = [(n, d, k) for n, d, k, _ in CASES]
    shapes += [(n, d, k) for n in (1, 513, 2048, 65536, 2 ** 31 - 1)
               for d in range(1, 129, 9) for k in range(1, 129, 7)]
    for n, d, k in shapes:
        assert 0 <= kmk.kmeans_tile(n, d, k) < len(kmk.KMEANS_TILES)


# ---------------------------------------------------------------------------
# What the launcher refuses before it reaches the card
# ---------------------------------------------------------------------------

def test_launcher_checks_operands_before_the_device():
    """Type, layout, limits, the tile and n are checked before the device,
    so each refusal shows on the CPU; a CPU or meta tensor is refused,
    never run on the plain version."""
    x, c = torch.zeros(50, 6), torch.zeros(4, 6)
    with pytest.raises(TypeError, match="x must be torch.float32"):
        kmk.kmeans_assign_kernel(x.double(), c)
    with pytest.raises(TypeError, match="centers must be torch.float32"):
        kmk.kmeans_assign_kernel(x, c.half())
    with pytest.raises(ValueError, match="x must be contiguous"):
        kmk.kmeans_assign_kernel(torch.zeros(6, 50).t(), c)
    with pytest.raises(ValueError, match="centers must be contiguous"):
        kmk.kmeans_assign_kernel(x, torch.zeros(6, 4).t())
    with pytest.raises(ValueError, match="centers"):
        kmk.kmeans_assign_kernel(torch.zeros(5, 129), torch.zeros(3, 129))
    with pytest.raises(ValueError, match="centers"):
        kmk.kmeans_assign_kernel(x, torch.zeros(129, 6))
    for tile in (-1, len(kmk.KMEANS_TILES)):
        with pytest.raises(ValueError, match="KMEANS_TILES"):
            kmk.kmeans_assign_kernel(x, c, tile=tile)
    for n in (0, 2 ** 31):
        with pytest.raises(ValueError, match="n must lie"):
            kmk.kmeans_assign_kernel(torch.empty(n, 6, device="meta"),
                                     torch.empty(4, 6, device="meta"))
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA device"):
            kmk.kmeans_assign_kernel(x.to(dev), c.to(dev), tile=0)


def test_dispatch_checks_once_and_counts_no_cpu_launch():
    """ops.kmeans_assign checks the limits and casts to fp32 itself, then
    takes the plain version for CPU tensors (no launch counted) and the
    launch for any other (a meta tensor raises at the device check)."""
    x = torch.from_numpy(_data(40, 6, 3, "", 0)[0])
    c = x[:3].clone()
    tops.kmeans_assign.launches = 0
    assert torch.equal(tops.kmeans_assign(x.double(), c),
                       kmk.kmeans_assign_plain(x, c))
    with pytest.raises(ValueError, match="CUDA device"):
        tops.kmeans_assign(x.to("meta"), c.to("meta"))
    assert tops.kmeans_assign.launches == 0


# ---------------------------------------------------------------------------
# The chain-order plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,what", CASES,
                         ids=[f"{n}x{d}x{k}" for n, d, k, _ in CASES])
def test_chain_order_matches_pallas_except_near_ties(n, d, k, what):
    """kmeans_assign_chain against the reference's Pallas kernel (interpret
    mode) at every chip_smoke.py case: equal except at counted near-ties;
    an exact tie (duplicated centers) goes to the lowest index."""
    x, c = _data(n, d, k, what, seed=n + d + k)
    got = kmk.kmeans_assign_chain(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = np.asarray(jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    flips = near_tie_flips(x, c, got.numpy(), want)
    assert flips <= max(2, n // 1000), flips
    if what.startswith("duplicated"):
        assert int(got.max()) < 10
        np.testing.assert_array_equal(got.numpy(), want)
    if k == 1:
        assert not bool(got.any())


def test_chain_is_the_ascending_fp32_sum():
    """The chain's distances are fp32 adds over ascending features from 0
    (numpy, rounding to fp32 after every add, gives the same argmin)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (300, 37)).astype(np.float32)
    c = rng.uniform(-1, 1, (9, 37)).astype(np.float32)
    acc = np.zeros((300, 9), np.float32)
    for t in range(37):
        acc = (acc + np.abs(x[:, t, None] - c[None, :, t])).astype(
            np.float32)
    got = kmk.kmeans_assign_chain(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), np.argmin(acc, axis=1))


def test_exact_ties_go_to_the_lowest_index():
    """Centers repeated, and centers at equal distance by symmetry: the
    chain-order version, the plain version and the reference all take the
    lowest index (0 for a zero sample or +e_i, 1 for -e_i)."""
    eye = np.eye(6, dtype=np.float32)
    x = np.concatenate([np.zeros((22, 6), np.float32),
                        eye[np.arange(21) % 6], -eye[np.arange(21) % 6]])
    c = np.stack([np.full(6, 1.0), np.full(6, -1.0), np.full(6, 1.0)])
    c = np.concatenate([c, c]).astype(np.float32)
    got = kmk.kmeans_assign_chain(torch.from_numpy(x), torch.from_numpy(c))
    plain = kmk.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
    ref = np.asarray(jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), [0] * 43 + [1] * 21)
