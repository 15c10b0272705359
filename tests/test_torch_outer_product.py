"""The dw and pulse kernels' shared batch walk (``csrc/outer_product.cuh``)
from the CPU: its tile table and the wrapper's choice of tile, the checks
the wrappers make before a launch, the build key that covers the headers,
and the one summation order that ties ``pulse_update`` to ``crossbar_dw``.

On the card ``chip_smoke.py`` holds the kernels to that order bit for bit:
(a) dw on int8 codes with a scale equals dw on ``codes.float() * scale``,
(b) ``pulse_update`` equals the plain pulse epilogue applied to the dw
kernel's product.  Here the plain versions are held to the same two
identities, exactly, and against the reference's Pallas kernels (interpret
mode): dw within 1e-5 absolute and relative (the two sides sum in
different orders), pulse counts equal except within 1e-4 of a
half-integer, as ``tests/test_torch_train_kernels.py`` holds them.
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
PULSE_BOUNDARY = 1e-4
MAX_DW, LEVELS = 0.05, 128
UNIT = MAX_DW / LEVELS
# (T, M, K, N): the main paths' stacks, cut in M, and ragged ones
SHAPES = [(1, 1, 8, 4), (3, 37, 41, 15), (2, 64, 400, 100),
          (1, 33, 100, 10), (6, 7, 45, 13), (4, 65, 17, 9)]


def _data(seed, T, M, K, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, M, K)) * 0.2).astype(np.float32)
    d = (rng.standard_normal((T, M, N)) * 0.1).astype(np.float32)
    codes = rng.integers(-127, 128, (T, M, N)).astype(np.int8)
    gp = rng.uniform(0.3, 0.7, (T, K, N)).astype(np.float32)
    gm = rng.uniform(0.3, 0.7, (T, K, N)).astype(np.float32)
    return x, d, codes, gp, gm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Tile table and choice
# ---------------------------------------------------------------------------

def _header_tiles():
    text = (_build.CSRC / "outer_product.cuh").read_text()
    rows = re.findall(r"X\((\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+),"
                      r"\s*(\d+),\s*(\d+)\)", text)
    assert [int(r[0]) for r in rows] == list(range(len(rows)))
    return tuple(tuple(int(v) for v in r[1:]) for r in rows)


def test_tile_table_is_the_headers():
    """The wrapper's table indexes the kernels' instances: it must be
    OUTER_PRODUCT_TILES of the header, row for row."""
    assert xbk.OUTER_PRODUCT_TILES == _header_tiles()


@pytest.mark.parametrize("tile", range(len(xbk.OUTER_PRODUCT_TILES)))
def test_tile_geometry(tile):
    """A tile's block covers 8 TK WK lines by 4 TN WN columns; its stages
    are whole batches of the sum and its ring fits a block's shared
    memory (227 KB), int8 windows included."""
    tk, tn, wk, wn, bm, s = xbk.OUTER_PRODUCT_TILES[tile]
    bk, bn = xbk.tile_dims(tile)
    assert (bk, bn) == (8 * tk * wk, 4 * tn * wn)
    assert tk in (2, 4) and tn in (2, 4) and 2 <= s <= 4
    u = 4 if tk * tn >= 8 else 8
    assert bm % u == 0
    rb = (bn + 15) // 16 * 16 + 16
    stage = -(-(4 * bm * (bk + bn) + bm * rb) // 128) * 128
    assert s * stage + 16 * s <= 227 * 1024


@pytest.mark.parametrize("shape,d_bytes,tile", [
    ((1, 4096, 784, 300), 1, 0), ((1, 4096, 300, 200), 1, 2),
    ((1, 4096, 200, 100), 1, 3), ((1, 4096, 100, 10), 1, 3),
    ((6, 4096, 400, 100), 4, 1), ((2, 4096, 400, 100), 4, 2),
    ((1, 4096, 400, 100), 4, 3), ((40, 256, 400, 100), 4, 4),
    ((60, 256, 400, 100), 4, 4), ((6, 256, 400, 100), 4, 1),
])
def test_main_path_tiles(shape, d_bytes, tile):
    """The main paths' launches take the tile the chip's sweep found
    fastest (``chip_smoke.py`` prints the sweep beside the pick)."""
    assert xbk.outer_product_tile(*shape, d_bytes) == tile


def test_tile_choice_is_valid_everywhere():
    for T, M, K, N in SHAPES + [(60, 4096, 400, 100), (1, 1, 1, 1)]:
        for d_bytes in (1, 4):
            tile = xbk.outer_product_tile(T, M, K, N, d_bytes)
            assert 0 <= tile < len(xbk.OUTER_PRODUCT_TILES)


@pytest.mark.parametrize("dims,match", [
    ((70000, 4, 8, 4), "grid too large"),          # T over gridDim.z
    ((1, 4, 8 * 160 * 65536, 4), "grid too large"),  # k-tiles over y
    ((0, 4, 8, 4), "empty"), ((1, 0, 8, 4), "empty"),
    ((1, 4, 0, 4), "empty"), ((1, 4, 8, 0), "empty"),
])
def test_pick_tile_refuses_grids_the_card_cannot_launch(dims, match):
    with pytest.raises(ValueError, match=match):
        xbk._pick_tile(None, *dims, 4)


@pytest.mark.parametrize("tile", [-1, len(xbk.OUTER_PRODUCT_TILES)])
def test_pick_tile_refuses_unknown_tiles(tile):
    with pytest.raises(ValueError, match="OUTER_PRODUCT_TILES"):
        xbk._pick_tile(tile, 1, 4, 8, 4, 4)


# ---------------------------------------------------------------------------
# What the launchers refuse before they reach the card
# ---------------------------------------------------------------------------

def test_operand_checks_come_before_the_device_check():
    """Type, rank and layout are checked before the device, so they show
    on the CPU too; every launcher checks every operand with them."""
    x = torch.zeros(2, 6, 8)
    for bad, err, match in ((x.double(), TypeError, "float32"),
                            (x[0], ValueError, "rank 3"),
                            (x.transpose(1, 2), ValueError, "contiguous"),
                            (x, ValueError, "CUDA")):
        with pytest.raises(err, match=match):
            xbk._check_operand("xs", bad, x)


def test_dw_launcher_refuses_wrong_errors():
    """Error values of another type, or codes in another layout, raise
    (that codes come with a scale, and only codes, is
    test_torch_train_kernels.py's)."""
    x, d, codes, _, _ = _t(*_data(0, 1, 4, 8, 4))
    with pytest.raises(TypeError, match="dys"):
        xbk.crossbar_dw_kernel(x, d.to(torch.int16))
    with pytest.raises(TypeError, match="dys"):
        xbk.crossbar_dw_kernel(x, d.double())
    with pytest.raises(ValueError, match="contiguous"):
        xbk.crossbar_dw_kernel(x, codes.transpose(1, 2).contiguous()
                               .transpose(1, 2), dy_scale=torch.ones(()))


def test_pulse_launcher_refuses_wrong_operands():
    x, d, _, gp, gm = _t(*_data(1, 2, 6, 8, 8))
    with pytest.raises(TypeError, match="g_plus"):
        xbk.pulse_update_kernel(gp.double(), gm, x, d, lr=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        xbk.pulse_update_kernel(gp.transpose(1, 2), gm, x, d, lr=0.1)
    with pytest.raises(ValueError, match="rank 3"):
        xbk.pulse_update_kernel(gp[0], gm, x, d, lr=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        xbk.pulse_update_kernel(gp, gm, x, d, lr=0.1)


# ---------------------------------------------------------------------------
# Build key
# ---------------------------------------------------------------------------

def _csrc_copy(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    return csrc


@pytest.mark.parametrize("name", ["crossbar_dw", "pulse_update",
                                  "crossbar_fwd"])
def test_build_key_covers_every_header(tmp_path, name):
    """An edited header rebuilds every source: the key hashes the source,
    every csrc/*.cuh and the flags (no nvcc needed to compute it)."""
    csrc = _csrc_copy(tmp_path)
    key = _build.source_digest(name, csrc)
    assert key == _build.source_digest(name, _build.CSRC)
    header = csrc / "outer_product.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_digest(name, csrc) != key
    (csrc / "new_header.cuh").write_text("// a new header\n")
    header.write_text(header.read_text().replace("\n// edited\n", ""))
    assert _build.source_digest(name, csrc) != key
    (csrc / "new_header.cuh").unlink()
    assert _build.source_digest(name, csrc) == key
    source = csrc / f"{name}.cu"
    source.write_text(source.read_text() + " ")
    assert _build.source_digest(name, csrc) != key


def test_build_finds_headers_in_csrc(tmp_path, monkeypatch):
    """nvcc is handed ``-I csrc`` and the key names the library."""
    calls = []

    class Done:
        returncode, stdout, stderr = 0, "ptxas info: 0 bytes spill", ""

    def fake_run(cmd, **_):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    lib = _build.load.__wrapped__("pulse_update")
    (cmd,) = calls
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
    assert "--use_fast_math" not in cmd
    key = _build.source_digest("pulse_update")
    assert lib.path.name == f"pulse_update-{key}.so"
    assert "spill" in lib.log and lib.build_s > 0


# ---------------------------------------------------------------------------
# One summation order: pins (a) and (b) of chip_smoke.py, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_dw_on_codes_is_dw_on_their_values(shape):
    """Pin (a)'s mirror: codes with a scale are ``codes.float() * scale``
    before the product, bit for bit."""
    x, _, codes, _, _ = _t(*_data(sum(shape), *shape))
    scale = torch.tensor(0.05 / 127)
    got = xbk.crossbar_dw_plain(x, codes, dy_scale=scale)
    want = xbk.crossbar_dw_plain(x, codes.float() * scale)
    assert torch.equal(got, want)
    via_ops = tops.crossbar_dw_stacked(x, codes, dy_scale=scale)
    assert torch.equal(via_ops, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lr", [0.01, "tensor"])
def test_pulse_is_the_epilogue_of_dw(shape, lr):
    """Pin (b)'s mirror: the plain pulse update is the pulse epilogue
    applied to the plain weight gradient's product, bit for bit, with a
    Python or a one-element tensor learning rate."""
    x, d, _, gp, gm = _t(*_data(3 * sum(shape), *shape))
    lr = torch.full((1,), 0.01) if lr == "tensor" else lr
    rule = dict(lr=lr, max_dw=MAX_DW, levels=LEVELS, w_max=1.0)
    got = xbk.pulse_update_plain(gp, gm, x, d, **rule)
    want = xbk.pulse_epilogue_plain(gp, gm, xbk.crossbar_dw_plain(x, d),
                                    **rule)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES[1:4])
def test_epilogue_of_dw_matches_pallas(shape):
    """The epilogue on the port's dw product against the reference's
    Pallas pulse_update and crossbar_dw (interpret mode)."""
    T, M, K, N = shape
    x, d, codes, gp, gm = _data(7 * sum(shape), *shape)
    lr = 0.25 / M ** 0.5
    dw = xbk.crossbar_dw_plain(*_t(x, d))
    for t in range(T):
        ref = jops.crossbar_dw(jnp.asarray(x[t]), jnp.asarray(d[t]))
        np.testing.assert_allclose(dw[t].numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=ATOL)
    got = xbk.pulse_epilogue_plain(*_t(gp, gm), dw, lr=lr, max_dw=MAX_DW,
                                   levels=LEVELS)
    acc = np.einsum("tmk,tmn->tkn", x.astype(np.float64),
                    d.astype(np.float64))
    counts = 2.0 * lr * acc / UNIT
    near = np.abs(counts - np.floor(counts) - 0.5) < PULSE_BOUNDARY
    for t in range(T):
        ref = jops.pulse_update(*map(jnp.asarray, (gp[t], gm[t], x[t],
                                                   d[t])), lr=lr)
        for g0, g, r in zip((gp[t], gm[t]), (got[0][t], got[1][t]), ref):
            kc = np.rint((g.numpy() - g0) / (UNIT / 2))
            pc = np.rint((np.asarray(r) - g0) / (UNIT / 2))
            diff = np.abs(kc - pc)
            assert diff.max(initial=0) <= 1
            assert not np.any((diff > 0) & ~near[t])
