"""The forward product's register-tiled walk (``csrc/row_product.cuh``) from
the CPU: its tile table and the wrapper's choice of tile, the checks the
forward and fused launchers make before a launch, the fused kernel's grid
under its new geometry, and the build key that covers the new header.

On the card ``chip_smoke.py`` holds every tile to the picked tile bit for
bit and the fused kernel to the four-call sequence bit for bit; here the
plain versions the kernels are held against are held against the
reference's Pallas forward (interpret mode) at the shapes the tiles are
picked for, within 1e-5 absolute and relative (the two sides sum in
different orders).
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
# (K, N) of every layer the main paths run through the forward kernel:
# crossbar_apply's / mlp_forward's mnist layers, mnist_dimred's last, kdd's
MNIST_LAYERS = [(784, 300), (300, 200), (200, 100), (100, 10)]
LAYERS = MNIST_LAYERS + [(100, 20), (41, 15), (15, 41)]
# (T, K, N) of the recognition stages (core/mapping.map_network, 400x100)
STAGES = [(6, 400, 100), (3, 200, 100), (2, 400, 100), (1, 400, 100),
          (40, 400, 100), (20, 200, 100), (60, 400, 100), (10, 600, 100),
          (15, 400, 100), (5, 300, 100)]


def _header_tiles():
    text = (_build.CSRC / "row_product.cuh").read_text()
    rows = re.findall(r"X\((\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+),"
                      r"\s*(\d+),\s*(\d+)\)", text)
    assert [int(r[0]) for r in rows] == list(range(len(rows)))
    return tuple(tuple(int(v) for v in r[1:]) for r in rows)


def _fwd_smem(tile):
    """fwd_smem_bytes of the header: per stage A (BM x (BR + 4) words), g+
    and g- (BR x BC words each), 128-byte aligned; three mbarriers a
    stage."""
    tm, tc, ntc, ntm, br, s = xbk.ROW_PRODUCT_TILES[tile]
    bm, bc = xbk.row_tile_dims(tile)

    def r128(b):
        return -(-b // 128) * 128

    return s * (r128(4 * bm * (br + 4)) + 2 * r128(4 * br * bc)) + 24 * s


# ---------------------------------------------------------------------------
# Tile table and choice
# ---------------------------------------------------------------------------

def test_tile_table_is_the_headers():
    """The wrapper's table indexes the kernel's instances: it must be
    ROW_PRODUCT_TILES of the header, row for row."""
    assert xbk.ROW_PRODUCT_TILES == _header_tiles()


@pytest.mark.parametrize("tile", range(len(xbk.ROW_PRODUCT_TILES)))
def test_tile_geometry(tile):
    """A tile's block is TM NTM rows by TC NTC columns of whole vectors;
    its stages are whole 4-line groups at a pitch of 4 (mod 8) words; its
    boxes fit a tensor map (at most 256 a side); its threads and its ring
    fit a block."""
    tm, tc, ntc, ntm, br, s = xbk.ROW_PRODUCT_TILES[tile]
    bm, bc = xbk.row_tile_dims(tile)
    assert (bm, bc) == (tm * ntm, tc * ntc)
    assert tc in (2, 4) and bc % 4 == 0 and br % 8 == 0
    assert (br + 4) % 8 == 4 and (br + 4) // 4 % 2 == 1
    assert max(bm, bc, br + 4) <= 256 and 2 <= s <= 4
    threads = -(-ntc * ntm // 32) * 32 + 32
    assert threads <= 1024
    assert _fwd_smem(tile) <= SMEM


def test_tiles_cover_a_chip_stage_without_padding():
    """N = 100, every chip stage's width, is one whole tile of 25 x 4
    columns for the tiles the many-output stages take."""
    for T, K, N in STAGES[:3]:
        tile = xbk.row_product_tile(T, 4096, K, N)
        assert xbk.row_tile_dims(tile)[1] == 100


@pytest.mark.parametrize("shape,tile", [
    ((6, 4096, 400, 100), 0), ((3, 4096, 200, 100), 0),
    ((2, 4096, 400, 100), 1), ((1, 4096, 400, 100), 2),
    ((40, 256, 400, 100), 0), ((1, 4096, 784, 300), 0),
    ((1, 4096, 300, 200), 1), ((1, 4096, 200, 100), 2),
    ((1, 4096, 100, 10), 3), ((6, 16, 400, 100), 3),
    ((6, 256, 400, 100), 2), ((1, 256, 400, 100), 3),
])
def test_main_path_tiles(shape, tile):
    """The main paths' launches take the tile the chip's sweep found
    fastest (``chip_smoke.py`` prints the sweep beside the pick)."""
    assert xbk.row_product_tile(*shape) == tile


def test_tile_choice_is_valid_everywhere():
    """Every main-path shape (chip stages of mnist and isolet at M = 1, 16,
    256, 4096; the layers of crossbar_apply, mnist_dimred and kdd) and
    ragged ones take a tile of the table whose grid the card can launch."""
    shapes = [(T, M, K, N) for T, K, N in STAGES for M in (1, 16, 256, 4096)]
    shapes += [(1, M, K, N) for K, N in LAYERS for M in (4, 64, 4096)]
    shapes += [(5, 3, 37, 11), (6, 7, 45, 13), (3, 37, 300, 26),
               (2, 70, 17, 9), (1, 1, 1, 1), (60, 65536, 784, 300)]
    for T, M, K, N in shapes:
        tile = xbk._pick_row_tile(None, T, M, K, N)
        assert 0 <= tile < len(xbk.ROW_PRODUCT_TILES)
        bm, _ = xbk.row_tile_dims(tile)
        assert -(-M // bm) <= xbk.MAX_GRID_YZ


@pytest.mark.parametrize("dims,match", [
    ((70000, 4, 8, 4), "grid too large"),            # T over gridDim.z
    ((1, 64 * 65536 + 1, 8, 100), "grid too large"),  # row tiles over y
    ((0, 4, 8, 4), "empty"), ((1, 0, 8, 4), "empty"),
    ((1, 4, 0, 4), "empty"), ((1, 4, 8, 0), "empty"),
])
def test_pick_row_tile_refuses_grids_the_card_cannot_launch(dims, match):
    with pytest.raises(ValueError, match=match):
        xbk._pick_row_tile(None, *dims)


@pytest.mark.parametrize("tile", [-1, len(xbk.ROW_PRODUCT_TILES)])
def test_pick_row_tile_refuses_unknown_tiles(tile):
    with pytest.raises(ValueError, match="ROW_PRODUCT_TILES"):
        xbk._pick_row_tile(tile, 1, 4, 8, 4)


# ---------------------------------------------------------------------------
# What the launchers refuse before they reach the card
# ---------------------------------------------------------------------------

def _operands(T=2, M=6, K=8, N=4):
    rng = np.random.default_rng(T * M + K * N)
    return [torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(np.float32))
            for s in ((T, M, K), (T, K, N), (T, K, N))]


def test_fwd_launcher_checks_operands_before_the_device():
    """Type, rank and layout are checked before the device, so they show
    on the CPU; every operand is checked."""
    x, gp, gm = _operands()
    with pytest.raises(TypeError, match="xs"):
        xbk.crossbar_fwd_kernel(x.double(), gp, gm)
    with pytest.raises(ValueError, match="rank 3"):
        xbk.crossbar_fwd_kernel(x[0], gp, gm)
    with pytest.raises(ValueError, match="contiguous"):
        xbk.crossbar_fwd_kernel(x.transpose(1, 2).contiguous()
                                .transpose(1, 2), gp, gm)
    with pytest.raises(ValueError, match="CUDA"):
        xbk.crossbar_fwd_kernel(x, gp, gm, tile=0)


def test_fused_launcher_checks_operands_before_the_device():
    x, gp, gm = _operands()
    d = torch.zeros(2, 6, 4)
    with pytest.raises(TypeError, match="dys"):
        xbk.crossbar_train_kernel(gp, gm, x, d.double(), lr=0.1)
    with pytest.raises(ValueError, match="rank 3"):
        xbk.crossbar_train_kernel(gp, gm, x, d[0], lr=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        xbk.crossbar_train_kernel(gp, gm, x, d.transpose(1, 2), lr=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        xbk.crossbar_train_kernel(gp, gm, x, d, lr=0.1)


# ---------------------------------------------------------------------------
# The fused kernel's geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", range(len(xbk.OUTER_PRODUCT_TILES)))
def test_fused_dx_blocks_take_the_update_walks_threads(tile):
    """One launch has one block size: the dx and y blocks are 8 column
    groups of 4 by as many row groups as the update walk's compute warps
    hold, 4 x 4 register tiles each (row_product::TrainTile)."""
    tk, tn, wk, wn, _, _ = xbk.OUTER_PRODUCT_TILES[tile]
    compute = 32 * wk * wn
    bm, bc = xbk.train_dx_dims(tile)
    assert bc == 8 * 4 and bm == 4 * (compute // 8)
    assert (bc // 4) * (bm // 4) == compute


@pytest.mark.parametrize("tile", range(len(xbk.OUTER_PRODUCT_TILES)))
@pytest.mark.parametrize("td", ["f32", "int8", "int32"])
def test_fused_shared_memory_fits_a_block(tile, td):
    """The launch's dynamic shared memory, the largest kind's, fits a
    block at every N the wrapper takes (N <= 128), with the forward on."""
    tk, tn, wk, wn, bmu, stages = xbk.OUTER_PRODUCT_TILES[tile]
    bk, bn = xbk.tile_dims(tile)
    raw = bmu * ((bn + 15) // 16 * 16 + 16) if td == "int8" else 0
    update = stages * (-(-(4 * bmu * (bk + bn) + raw) // 128) * 128 + 16)
    bm, bc = xbk.train_dx_dims(tile)
    for N in (1, 13, 26, 100, 101, 128):
        p = -(-N // 4) * 4
        p += 0 if p // 4 % 2 else 4
        assert p % 8 == 4 and p >= N
        ring = -(-4 * bm * p // 128) * 128
        if td == "int8":
            ring += -(-bm * ((p + 15) // 16 * 16 + 16) // 128) * 128
        dx = -(-4 * N * (bc + 4) // 128) * 128 + 3 * ring + 48
        y = 3 * (-(-4 * bm * 36 // 128) * 128 + 2 * 4 * 32 * bc) + 72
        assert max(update, dx, y) <= SMEM, (N, update, dx, y)


@pytest.mark.parametrize("shape,tile,run,blocks", [
    # the compiled mnist step's four stacks at M = 4096: update tiles of
    # 32 x 32 (tile 1), 96 x 8 (2) and 48 x 8 (3); dx row tiles of 64, 48
    # and 48 samples by 32 columns (13 a core of 400 lines)
    ((6, 4096, 400, 100), 1, 8, 6 * (13 * 4 + 13 * 8)),
    ((2, 4096, 400, 100), 2, 8, 2 * (5 * 13 + 13 * 11)),
    ((1, 4096, 400, 100), 3, 8, 9 * 13 + 13 * 11),
    # isolet's largest stack at M = 256 (4 row tiles), and one sample
    ((40, 256, 400, 100), 4, 4, 40 * (13 * 4 + 13)),
    ((1, 1, 400, 100), 3, 1, 9 * 13 + 13),
])
def test_fused_grid_follows_the_geometry(shape, tile, run, blocks):
    """The fused wrapper's one-dimensional grid: update blocks of the
    picked walk tile (BK x BN), dx blocks of 32 columns walking runs of
    row tiles, up to DX_RUN a block."""
    T, M, K, N = shape
    assert xbk.outer_product_tile(T, M, K, N, 4) == tile
    assert xbk.train_dx_run(M, tile) == run
    assert xbk.train_blocks(T, M, K, N, tile, run, False) == blocks
    bm, bc = xbk.train_dx_dims(tile)
    m_tiles = -(-M // bm)
    with_y = blocks + T * -(-N // bc) * m_tiles
    assert xbk.train_blocks(T, M, K, N, tile, run, True) == with_y


def test_fused_dx_runs_split_the_row_tiles_evenly():
    """A run never exceeds DX_RUN or the core's row tiles, and the runs of
    a core differ by at most one tile."""
    for M in (1, 7, 256, 4096, 4097, 65536):
        for tile in range(len(xbk.OUTER_PRODUCT_TILES)):
            run = xbk.train_dx_run(M, tile)
            m_tiles = -(-M // xbk.train_dx_dims(tile)[0])
            groups = -(-m_tiles // run)
            assert 1 <= run <= min(m_tiles, xbk.DX_RUN)
            assert groups * run - m_tiles < groups


# ---------------------------------------------------------------------------
# Build key and source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["crossbar_fwd", "crossbar_train"])
def test_build_key_covers_the_new_header(tmp_path, name):
    """An edited row_product.cuh rebuilds both sources that include it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    key = _build.source_digest(name, csrc)
    assert key == _build.source_digest(name, _build.CSRC)
    header = csrc / "row_product.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_digest(name, csrc) != key


def test_sources_take_the_shared_walks():
    """crossbar_fwd.cu instantiates the forward walk for every tile;
    crossbar_train.cu the update walk of outer_product.cuh and the dx and y
    walks of row_product.cuh; the fwd entry point takes the tile."""
    fwd = (_build.CSRC / "crossbar_fwd.cu").read_text()
    assert '#include "row_product.cuh"' in fwd
    assert "row_product::fwd_walk<C>" in fwd
    assert "ROW_PRODUCT_TILES(ROW_PRODUCT_CASE)" in fwd
    head = fwd.split('extern "C" int crossbar_fwd_launch(')[1]
    # 4 pointers, T, M, K, N, activation, adc, adc_range, scale, tile,
    # stream: the 14 argtypes _launch_fn declares
    assert head.split(")")[0].count(",") + 1 == 14
    train = (_build.CSRC / "crossbar_train.cu").read_text()
    for needed in ("outer_product::batch_walk<U, TD>",
                   "row_product::dx_walk<R, TD>", "row_product::fwd_walk<R>",
                   "OUTER_PRODUCT_TILES(OUTER_PRODUCT_CASE)"):
        assert needed in train, needed


# ---------------------------------------------------------------------------
# The plain version against the reference, at the shapes the tiles serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", LAYERS)
@pytest.mark.parametrize("adc", [False, True])
def test_plain_forward_matches_pallas_on_every_layer(K, N, adc):
    """``ops.crossbar_fwd`` (the plain version on the CPU) against the
    reference's Pallas forward at each layer the forward kernel serves,
    with the hard-sigmoid and, where asked, the 3-bit ADC: values within
    1e-5, or 3-bit codes equal except within 1e-6 of a half-step."""
    rng = np.random.default_rng(K * N + adc)
    x = rng.uniform(-0.5, 0.5, (37, K)).astype(np.float32)
    gp = rng.uniform(0.0, 0.02, (K, N)).astype(np.float32)
    gm = rng.uniform(0.0, 0.02, (K, N)).astype(np.float32)
    bits = 3 if adc else None
    got = tops.crossbar_fwd(*map(torch.from_numpy, (x, gp, gm)),
                            activation=True, adc_bits=bits).numpy()
    ref = np.asarray(jops.crossbar_fwd(jnp.asarray(x), jnp.asarray(gp),
                                       jnp.asarray(gm), activation=True,
                                       adc_bits=bits))
    if not adc:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
        return
    scale = 1.0 / 7
    pre = np.clip(0.25 * (x.astype(np.float64) @ (gp.astype(np.float64)
                                                  - gm)), -0.5, 0.5)
    u = (pre + 0.5) / scale
    flip = np.rint((got + 0.5) / scale) != np.rint((ref + 0.5) / scale)
    assert not np.any(flip & (np.abs(u - np.floor(u) - 0.5) * scale > 1e-6))
