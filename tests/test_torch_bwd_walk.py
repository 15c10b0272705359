"""The error-backprop kernel's walks (``csrc/crossbar_bwd.cu`` over
``csrc/row_product.cuh``'s ``dx_walk`` and ``dx_ring_walk``) from the CPU:
its tile table and the wrapper's choice of tile and run, the shared memory
of every instance, the checks the launcher makes before a launch, and the
build key.

On the card ``chip_smoke.py`` holds every tile and run to the picked one bit
for bit and the picked kernel to the fused kernel's dx bit for bit; here
the plain version the kernel is held against is held against the
reference's Pallas ``crossbar_bwd`` (interpret mode) at the shapes the
tiles are picked for, fp32 errors and int8 codes, within 1e-5 absolute and
relative (the two sides sum in different orders).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import crossbar as xbk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
SMEM = 227 * 1024          # a block's shared memory on an H100
# (K, N) of mnist's layers: crossbar_apply's bwd launches, N = 300 included
MNIST_LAYERS = [(784, 300), (300, 200), (200, 100), (100, 10)]
# (T, K, N) of the chip's stages (core/mapping.map_network, 400x100)
STAGES = [(6, 400, 100), (3, 200, 100), (2, 400, 100), (1, 400, 100),
          (40, 400, 100), (20, 200, 100), (60, 400, 100), (10, 600, 100),
          (15, 400, 100), (5, 300, 100)]
TILES = range(len(xbk.CROSSBAR_BWD_TILES))


def _header_tiles():
    text = (_build.CSRC / "crossbar_bwd.cu").read_text()
    body = text.split("#define CROSSBAR_BWD_TILES(X)")[1].split("\n\n")[0]
    rows = re.findall(r"X\((\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+),"
                      r"\s*(\d+),\s*(\d+)\)", body)
    assert [int(r[0]) for r in rows] == list(range(len(rows)))
    return tuple(tuple(int(v) for v in r[1:]) for r in rows)


def _shapes():
    """Every main-path bwd shape and a few ragged ones."""
    shapes = [(T, M, K, N) for T, K, N in STAGES for M in (1, 16, 64, 256,
                                                           4096)]
    shapes += [(1, M, K, N) for K, N in MNIST_LAYERS for M in (1, 64, 4096)]
    return shapes + [(3, 37, 300, 26), (6, 7, 45, 13), (5, 3, 129, 101),
                     (2, 70, 17, 9), (1, 1, 1, 1), (60, 65536, 784, 300)]


# ---------------------------------------------------------------------------
# Tile table, choice and geometry
# ---------------------------------------------------------------------------

def test_tile_table_is_the_sources():
    """The wrapper's table indexes the kernel's instances: it must be
    CROSSBAR_BWD_TILES of crossbar_bwd.cu, row for row."""
    assert xbk.CROSSBAR_BWD_TILES == _header_tiles()


@pytest.mark.parametrize("tile", TILES)
def test_tile_geometry(tile):
    """A tile is row_product::Tile's: TM NTM rows by TC NTC columns of whole
    vectors, ring stages of whole 4-line groups at a pitch of 4 (mod 8)
    words, tensor-map boxes of at most 256 a side (BM x P, BM x (BR + 4),
    BC x (BR + 4)) and a block the card can launch."""
    tm, tc, ntc, ntm, br, s = xbk.CROSSBAR_BWD_TILES[tile]
    bm, bc = xbk.bwd_tile_dims(tile)
    assert (bm, bc) == (tm * ntm, tc * ntc)
    assert tc in (2, 4) and bc % 4 == 0 and br % 8 == 0
    assert (br + 4) % 8 == 4 and 2 <= s <= 4
    assert max(bm, bc, br + 4, 132) <= 256
    assert -(-ntc * ntm // 32) * 32 + 32 <= 1024


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("d_bytes", [4, 1])
def test_shared_memory_fits_a_block(tile, d_bytes):
    """Every instance's dynamic shared memory fits a block: dx_walk's at
    each N it takes (the launcher asks for its N = 128 size once) and the
    ring walk's, which does not depend on N."""
    for N in (1, 13, 26, 100, 101, 127, 128):
        assert xbk.bwd_smem(tile, N, d_bytes) <= \
            xbk.bwd_smem(tile, 128, d_bytes) <= SMEM
    assert xbk.bwd_smem(tile, 129, d_bytes) == \
        xbk.bwd_smem(tile, 300, d_bytes) <= SMEM


def test_shared_memory_follows_the_header():
    """bwd_smem spelled out for one tile (4 x 4 register tiles, 64 x 32,
    three stages): dx_walk at N = 100 (pitch 100) and the ring walk."""
    tile = xbk.CROSSBAR_BWD_TILES.index((4, 4, 8, 16, 32, 3))
    b = 4 * 100 * 36                        # w^T, N x (BC + 4) words
    stage = 4 * 64 * 100                    # a row tile of d
    assert xbk.bwd_smem(tile, 100, 4) == -(-b // 128) * 128 + 3 * (stage
                                                                 + 16)
    raw = 64 * (112 + 16)                   # int8 windows, 112 >= P + 15
    assert xbk.bwd_smem(tile, 100, 1) == (-(-b // 128) * 128
                                          + 3 * (stage + raw + 16))
    ring = 4 * 64 * 36 + 4 * 32 * 32 + 2 * 4 * 32 * 36
    assert xbk.bwd_smem(tile, 300, 4) == 3 * (ring + 24)


def test_every_pick_is_valid_everywhere():
    """Every main-path shape (the chip's stages of mnist and isolet at M =
    1 .. 4096; mnist's layers, N = 300 and 200 through the ring walk) and
    ragged ones take a tile and run of the table whose grid the card can
    launch, for fp32 errors and for codes."""
    for T, M, K, N in _shapes():
        for d_bytes in (4, 1):
            tile, run = xbk._pick_bwd(None, None, T, M, K, N, d_bytes)
            assert 0 <= tile < len(xbk.CROSSBAR_BWD_TILES)
            bm, bc = xbk.bwd_tile_dims(tile)
            m_tiles = -(-M // bm)
            assert 1 <= run <= min(m_tiles, xbk.BWD_RUN)
            if N > xbk.MAX_N_DX_WALK:
                assert run == 1
            assert -(-m_tiles // run) <= xbk.MAX_GRID_YZ
            assert -(-K // bc) <= xbk.MAX_GRID_X


def test_runs_split_the_row_tiles_evenly():
    """A run never exceeds BWD_RUN or the core's row tiles, and the runs of
    a core differ by at most one tile."""
    for T, M, K, N in _shapes():
        for tile in TILES:
            run = xbk.bwd_run(T, M, K, N, tile)
            m_tiles = -(-M // xbk.bwd_tile_dims(tile)[0])
            groups = -(-m_tiles // run)
            assert 1 <= run <= min(m_tiles, xbk.BWD_RUN)
            assert groups * run - m_tiles < groups


@pytest.mark.parametrize("dims,match", [
    ((70000, 4, 8, 4), "grid too large"),              # T over gridDim.z
    ((1, 64 * 65536 * 8 + 1, 8, 100), "grid too large"),  # runs over y
    ((1, 64 * 65536 + 1, 8, 300), "grid too large"),   # ring: row tiles
    ((0, 4, 8, 4), "empty"), ((1, 0, 8, 4), "empty"),
    ((1, 4, 0, 4), "empty"), ((1, 4, 8, 0), "empty"),
])
def test_pick_refuses_grids_the_card_cannot_launch(dims, match):
    with pytest.raises(ValueError, match=match):
        xbk._pick_bwd(None, None, *dims, 4)


@pytest.mark.parametrize("tile,run,match", [
    (-1, None, "CROSSBAR_BWD_TILES"),
    (len(xbk.CROSSBAR_BWD_TILES), None, "CROSSBAR_BWD_TILES"),
    (0, 0, "run"), (0, -3, "run"),
])
def test_pick_refuses_unknown_tiles_and_runs(tile, run, match):
    with pytest.raises(ValueError, match=match):
        xbk._pick_bwd(tile, run, 1, 4, 8, 4, 4)


# ---------------------------------------------------------------------------
# What the launcher refuses before it reaches the card
# ---------------------------------------------------------------------------

def _operands(T=2, M=6, K=8, N=4):
    rng = np.random.default_rng(T * M + K * N)
    return [torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(np.float32))
            for s in ((T, M, N), (T, K, N), (T, K, N))]


def test_launcher_checks_operands_before_the_device():
    """Type, rank, layout, codes without a scale, shapes, tile and run are
    checked before the device, so they show on the CPU; a CPU tensor is
    refused, never run on the plain version."""
    d, gp, gm = _operands()
    scale = torch.tensor(0.05 / 127)
    with pytest.raises(TypeError, match="dys"):
        xbk.crossbar_bwd_kernel(d.double(), gp, gm)
    with pytest.raises(ValueError, match="rank 3"):
        xbk.crossbar_bwd_kernel(d[0], gp, gm)
    with pytest.raises(ValueError, match="contiguous"):
        xbk.crossbar_bwd_kernel(d.transpose(1, 2).contiguous()
                                .transpose(1, 2), gp, gm)
    with pytest.raises(ValueError, match="dy_scale"):
        xbk.crossbar_bwd_kernel(d.to(torch.int8), gp, gm)
    with pytest.raises(ValueError, match="dy_scale"):
        xbk.crossbar_bwd_kernel(d, gp, gm, dy_scale=scale)
    for args, kw in (((d, gp, gm), {}),
                     ((d.to(torch.int8), gp, gm), {"dy_scale": scale}),
                     ((d.to(torch.int32), gp, gm), {"dy_scale": scale})):
        with pytest.raises(ValueError, match="CUDA"):
            xbk.crossbar_bwd_kernel(*args, **kw)


def test_launcher_checks_shapes_tile_and_grid_before_the_device(monkeypatch):
    """With the device rule out of the way (this machine has no card),
    every operand's type and layout, the shapes, the tile, the run and the
    grid are still checked before any launch."""
    def no_device_rule(name, t, like, dtypes=(torch.float32,)):
        if t.dtype not in dtypes:
            raise TypeError(name)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def no_launch(*_):
        raise AssertionError("reached the launch")

    monkeypatch.setattr(xbk, "_check_operand", no_device_rule)
    monkeypatch.setattr(xbk, "_run", no_launch)
    d, gp, gm = _operands()
    with pytest.raises(TypeError, match="g_plus"):
        xbk.crossbar_bwd_kernel(d, gp.double(), gm)
    with pytest.raises(ValueError, match="g_minus must be contiguous"):
        xbk.crossbar_bwd_kernel(d, gp, gm.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        xbk.crossbar_bwd_kernel(d, gp[:, :5].contiguous(), gm)
    with pytest.raises(ValueError, match="CROSSBAR_BWD_TILES"):
        xbk.crossbar_bwd_kernel(d, gp, gm, tile=99)
    with pytest.raises(ValueError, match="run"):
        xbk.crossbar_bwd_kernel(d, gp, gm, run=0)
    big = torch.empty((70000, 1, 4), device="meta")
    gbig = torch.empty((70000, 8, 4), device="meta")
    with pytest.raises(ValueError, match="grid too large"):
        xbk.crossbar_bwd_kernel(big, gbig, gbig)


# ---------------------------------------------------------------------------
# Build key and source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("header", ["row_product.cuh", "outer_product.cuh"])
def test_build_key_covers_the_walks_headers(tmp_path, header):
    """crossbar_bwd.cu instantiates row_product.cuh's walks (which use
    outer_product.cuh's copies and barriers): an edit to either header
    rebuilds it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    key = _build.source_digest("crossbar_bwd", csrc)
    assert key == _build.source_digest("crossbar_bwd", _build.CSRC)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.source_digest("crossbar_bwd", csrc) != key


def test_source_takes_both_walks_for_every_tile():
    """crossbar_bwd.cu includes row_product.cuh, instantiates dx_walk (the
    fused kernel's dx walk) and dx_ring_walk for every tile, and its entry
    point takes the tile and the run: the 13 argtypes _launch_fn
    declares."""
    src = (_build.CSRC / "crossbar_bwd.cu").read_text()
    assert '#include "row_product.cuh"' in src
    for needed in ("row_product::dx_walk<C, TD>",
                   "row_product::dx_ring_walk<C, TD>",
                   "CROSSBAR_BWD_TILES(CROSSBAR_BWD_CASE)"):
        assert needed in src, needed
    head = src.split('extern "C" int crossbar_bwd_launch(')[1]
    assert head.split(")")[0].count(",") + 1 == 13
    train = (_build.CSRC / "crossbar_train.cu").read_text()
    assert "row_product::dx_walk<R, TD>" in train


# ---------------------------------------------------------------------------
# The plain version against the reference, at the shapes the tiles serve
# ---------------------------------------------------------------------------

def _data(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.05, 0.05, (M, N)).astype(np.float32),
            rng.uniform(0.3, 0.7, (K, N)).astype(np.float32),
            rng.uniform(0.3, 0.7, (K, N)).astype(np.float32),
            rng.integers(-127, 128, (M, N)).astype(np.int8))


@pytest.mark.parametrize("K,N", MNIST_LAYERS)
@pytest.mark.parametrize("codes", [False, True])
def test_plain_bwd_matches_pallas_on_every_layer(K, N, codes):
    """``ops.crossbar_bwd`` (the plain version on the CPU) against the
    reference's Pallas ``crossbar_bwd`` at each mnist layer, with fp32
    errors and with int8 codes and a scale: within 1e-5."""
    d, gp, gm, c8 = _data(K * N + codes, 37, K, N)
    scale = np.float32(0.05 / 127)
    if codes:
        got = tops.crossbar_bwd(torch.from_numpy(c8), torch.from_numpy(gp),
                                torch.from_numpy(gm),
                                dy_scale=torch.tensor(scale))
        ref = jops.crossbar_bwd(jnp.asarray(c8), jnp.asarray(gp),
                                jnp.asarray(gm), dy_scale=jnp.asarray(scale))
    else:
        got = tops.crossbar_bwd(*map(torch.from_numpy, (d, gp, gm)))
        ref = jops.crossbar_bwd(*map(jnp.asarray, (d, gp, gm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("T,K,N", [(6, 400, 100), (2, 400, 100),
                                   (5, 300, 100)])
def test_plain_bwd_matches_pallas_on_chip_stages(T, K, N):
    """``ops.crossbar_bwd_stacked`` against the reference's stacked Pallas
    call at chip stage stacks (a few samples): within 1e-5."""
    rng = np.random.default_rng(T * K)
    d = rng.uniform(-0.05, 0.05, (T, 9, N)).astype(np.float32)
    gp = rng.uniform(0.3, 0.7, (T, K, N)).astype(np.float32)
    gm = rng.uniform(0.3, 0.7, (T, K, N)).astype(np.float32)
    got = tops.crossbar_bwd_stacked(*map(torch.from_numpy, (d, gp, gm)))
    ref = jops.crossbar_bwd_stacked(*map(jnp.asarray, (d, gp, gm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_codes_are_their_values_before_the_product():
    """The kernel's dequantization (``__fmul_rn(float(code), scale)`` in
    shared memory) mirrored on the CPU: bwd on codes with a scale equals
    bwd on ``codes.float() * scale``, bit for bit, int8 and int32."""
    d, gp, gm, c8 = _data(3, 37, 300, 26)
    scale = torch.tensor(np.float32(0.05 / 127))
    gp, gm = torch.from_numpy(gp)[None], torch.from_numpy(gm)[None]
    c8 = torch.from_numpy(c8)[None]
    want = xbk.crossbar_bwd_plain(c8.float() * scale, gp, gm)
    for codes in (c8, c8.to(torch.int32)):
        assert torch.equal(xbk.crossbar_bwd_plain(codes, gp, gm,
                                                  dy_scale=scale), want)
