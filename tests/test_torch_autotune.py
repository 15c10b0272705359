"""The crossbar tile autotuner (``repro_torch.kernels.ops.block_config``
and its persisted table), the port of the reference's block autotuner.

The reference's two tests of it (``tests/test_compiled_step.py``,
``test_block_cache_is_bounded_lru`` and
``test_stacked_autotune_key_includes_fold_and_persists``) are mirrored
with a fake ``time_fn`` and a table under ``tmp_path``.  With autotuning
off, every launch takes the decision lists' tile at every shape the tile
tests use; a CPU call never times and never caches.  The timing itself,
by CUDA events on the card, is ``chip_smoke.py``'s step 25.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import crossbar as xbk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (T, M, K, N) of the chip's recognition and training stages and mnist's
# layers, as tests/test_torch_row_product.py, test_torch_outer_product.py
# and test_torch_bwd_walk.py take them
STAGES = [(6, 400, 100), (3, 200, 100), (2, 400, 100), (1, 400, 100),
          (40, 400, 100), (20, 200, 100), (60, 400, 100), (10, 600, 100),
          (15, 400, 100), (5, 300, 100)]
LAYERS = [(784, 300), (300, 200), (200, 100), (100, 10), (100, 20),
          (41, 15), (15, 41)]
SHAPES = ([(T, M, K, N) for T, K, N in STAGES
           for M in (1, 16, 64, 256, 4096)]
          + [(1, M, K, N) for K, N in LAYERS for M in (1, 4, 64, 4096)]
          + [(1, 1, 8, 4), (3, 37, 41, 15), (2, 64, 400, 100),
             (1, 33, 100, 10), (6, 7, 45, 13), (4, 65, 17, 9),
             (5, 3, 37, 11), (3, 37, 300, 26), (2, 70, 17, 9),
             (5, 3, 129, 101), (1, 1, 1, 1), (60, 65536, 784, 300),
             (60, 4096, 400, 100)])
OPS = ("fwd", "fwd_stacked", "bwd", "bwd_stacked", "dw", "dw_stacked",
       "pulse", "pulse_stacked", "train_stacked", "train_stacked_y")


@pytest.fixture
def fresh_cache(monkeypatch, tmp_path):
    """An empty cache and tuned set, a table under ``tmp_path``, the
    switch off; the process's entries come back afterwards."""
    saved, saved_tuned = dict(ops._BLOCK_CACHE), set(ops._TUNED_KEYS)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_XBAR_AUTOTUNE", raising=False)
    ops._BLOCK_CACHE.clear()
    ops._TUNED_KEYS.clear()
    yield tmp_path / "autotune.json"
    ops._BLOCK_CACHE.clear()
    ops._BLOCK_CACHE.update(saved)
    ops._TUNED_KEYS.clear()
    ops._TUNED_KEYS.update(saved_tuned)


# ---------------------------------------------------------------------------
# The reference's tests, mirrored
# ---------------------------------------------------------------------------

def test_block_cache_is_bounded_lru(fresh_cache):
    for i in range(ops._BLOCK_CACHE_MAX + 50):
        ops.block_config("fwd", 1, 8, 16 + i, 8)
    assert len(ops._BLOCK_CACHE) == ops._BLOCK_CACHE_MAX
    assert ("fwd", 1, 8, 16, 8, 4) not in ops._BLOCK_CACHE
    assert ("fwd", 1, 8, 16 + ops._BLOCK_CACHE_MAX + 49, 8, 4) \
        in ops._BLOCK_CACHE


def test_stacked_autotune_key_includes_fold_and_persists(fresh_cache):
    table = fresh_cache
    timed = []

    def time_fn(*choice):
        timed.append(choice)

    # one timing pass per (op, fold, shape); a second call — and a call
    # with another shape hitting the same fold — must not re-time
    b1 = ops.block_config("fwd_stacked", 32, 4, 41, 15, fold=8,
                          autotune=True, time_fn=time_fn)
    n_timed = len(timed)
    assert n_timed > 0
    assert ops.block_config("fwd_stacked", 32, 4, 41, 15, fold=8,
                            autotune=True, time_fn=time_fn) == b1
    assert len(timed) == n_timed, "re-timed a cached stacked shape"
    # a different farm size is a different fold -> its own entry
    ops.block_config("fwd_stacked", 32, 4, 41, 15, fold=16,
                     autotune=True, time_fn=time_fn)
    assert len(timed) == 2 * n_timed
    assert ("fwd_stacked", 8, 32, 4, 41, 15, 4) in ops._BLOCK_CACHE
    assert ("fwd_stacked", 16, 32, 4, 41, 15, 4) in ops._BLOCK_CACHE
    # an untuned default (no timing pass) is cached for dispatch but
    # NEVER persisted — a persisted default would read as "already
    # tuned" on reload and suppress the timing pass forever ...
    ops.block_config("fwd_stacked", 36, 9, 41, 15, fold=8)
    ops.save_autotune_table()
    with open(table) as f:
        assert "fwd_stacked|8|36|9|41|15|4" not in json.load(f)
    # ... and a later real timing opportunity upgrades it in place
    ops.block_config("fwd_stacked", 36, 9, 41, 15, fold=8, autotune=True,
                     time_fn=time_fn)
    assert ("fwd_stacked", 8, 36, 9, 41, 15, 4) in ops._TUNED_KEYS
    # persistence round-trip
    assert table.exists()
    ops._BLOCK_CACHE.clear()
    assert ops.load_autotune_table() >= 2
    assert ops._BLOCK_CACHE[("fwd_stacked", 8, 32, 4, 41, 15, 4)] == b1


# ---------------------------------------------------------------------------
# The port's rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("d_bytes", [4, 1])
def test_autotune_off_takes_the_decision_lists_pick(fresh_cache, op,
                                                    d_bytes):
    """With autotuning off every shape the tile tests use gets exactly
    the tile the launchers pick by themselves today, whatever a table
    says: a tuned entry that differs does not move it."""
    kind = op.split("_")[0]
    for T, M, K, N in SHAPES:
        if kind == "fwd":
            want = (xbk.row_product_tile(T, M, K, N),)
        elif kind == "bwd":
            want = (xbk.bwd_tile(T, M, K, N, d_bytes),)
            want += (xbk.bwd_run(T, M, K, N, want[0]),)
        else:
            want = (xbk.outer_product_tile(T, M, K, N, d_bytes),)
        assert ops.block_config(op, T, M, K, N, d_bytes=d_bytes) == want
        key = (op, T, M, K, N, d_bytes)
        other = ((want[0] + 1) % 3,) + want[1:]
        ops._block_cache_put(key, other, tuned=True)
        assert ops.block_config(op, T, M, K, N, d_bytes=d_bytes,
                                autotune=False, time_fn=pytest.fail) == want
        assert ops._BLOCK_CACHE[key] == other


def test_the_switch_turns_tuning_on(fresh_cache, monkeypatch):
    """``REPRO_TORCH_XBAR_AUTOTUNE=1`` is the default of ``autotune``;
    ``autotune=False`` overrides it."""
    timed = []
    monkeypatch.setenv("REPRO_TORCH_XBAR_AUTOTUNE", "1")
    ops.block_config("dw", 1, 64, 400, 100, time_fn=timed.append)
    assert timed and ("dw", 1, 64, 400, 100, 4) in ops._TUNED_KEYS
    n = len(timed)
    ops.block_config("dw", 1, 64, 300, 100, autotune=False,
                     time_fn=timed.append)
    assert len(timed) == n


def test_tuning_keeps_the_fastest_candidate(fresh_cache):
    """Each candidate runs twice (a warm-up, then the timed call); the
    fastest timed call wins and is persisted."""
    calls = []
    cands = ops.tile_candidates("bwd_stacked", 6, 4096, 400, 100, 1)
    slow = set(cands) - {cands[-1]}

    def time_fn(*choice):
        calls.append(choice)
        if choice in slow:
            time.sleep(0.02)

    got = ops.block_config("bwd_stacked", 6, 4096, 400, 100, d_bytes=1,
                           autotune=True, time_fn=time_fn)
    assert got == cands[-1] and got != cands[0]
    assert sorted(calls) == sorted(cands * 2)
    with open(fresh_cache) as f:
        assert json.load(f) == {"bwd_stacked|6|4096|400|100|1": list(got)}


def test_no_timing_pass_without_a_runner(fresh_cache):
    """Without a runner (a CUDA-graph capture) a tuning request gets the
    tuned entry or the default, and the default is not cached, so a later
    eager call can still tune."""
    want = ops.default_tile("fwd", 1, 4096, 896, 4864)
    assert ops.block_config("fwd", 1, 4096, 896, 4864, autotune=True) == want
    assert not ops._BLOCK_CACHE
    ops._block_cache_put(("fwd", 1, 4096, 896, 4864, 4), (1,), tuned=True)
    assert ops.block_config("fwd", 1, 4096, 896, 4864, autotune=True) == (1,)


@pytest.mark.parametrize("op", OPS)
def test_candidates_fit_the_shape(op):
    """The default comes first; every candidate indexes its table and
    passes its launcher's grid checks; bwd's shared memory fits a block
    and its run is 1 above N = 128."""
    kind = op.split("_")[0]
    for T, M, K, N in SHAPES:
        for d_bytes in (4, 1):
            cands = ops.tile_candidates(op, T, M, K, N, d_bytes)
            assert cands[0] == ops.default_tile(op, T, M, K, N, d_bytes)
            assert len(set(cands)) == len(cands)
            for c in cands:
                if kind == "fwd":
                    xbk._pick_row_tile(c[0], T, M, K, N)
                elif kind == "bwd":
                    xbk._pick_bwd(c[0], c[1], T, M, K, N, d_bytes)
                    assert xbk.bwd_smem(c[0], N, d_bytes) <= \
                        ops.SMEM_PER_BLOCK
                    assert N <= xbk.MAX_N_DX_WALK or c[1] == 1
                elif kind == "train" and N <= xbk.MAX_N_TRAIN:
                    assert 0 <= c[0] < len(xbk.OUTER_PRODUCT_TILES)
                else:
                    xbk._pick_tile(c[0], T, M, K, N, d_bytes)


def test_cpu_calls_never_time_and_never_cache(fresh_cache, monkeypatch):
    """On CPU tensors every wrapper runs its plain version, which has no
    tile: ``block_config`` is never asked, even with tuning on."""
    def refuse(*a, **k):
        raise AssertionError("block_config on the CPU")

    monkeypatch.setenv("REPRO_TORCH_XBAR_AUTOTUNE", "1")
    monkeypatch.setattr(ops, "block_config", refuse)
    x, d = torch.ones(2, 8, 6), torch.ones(2, 8, 4)
    gp, gm = torch.ones(2, 6, 4), torch.zeros(2, 6, 4)
    codes, scale = d.to(torch.int8), torch.tensor(0.01)
    ops.crossbar_fwd(x[0], gp[0], gm[0], autotune=True)
    ops.crossbar_bwd(codes[0], gp[0], gm[0], dy_scale=scale, autotune=True)
    ops.crossbar_dw(x[0], d[0], autotune=True)
    ops.pulse_update(gp[0], gm[0], x[0], d[0], lr=0.1, autotune=True)
    ops.crossbar_fwd_stacked(x, gp, gm, autotune=True)
    ops.crossbar_bwd_stacked(d, gp, gm, autotune=True)
    ops.crossbar_dw_stacked(x[None], d[None], autotune=True)
    ops.pulse_update_stacked(gp, gm, x, d, lr=0.1, autotune=True)
    ops.crossbar_train_stacked(gp, gm, x, d, lr=0.1, compute_y=True,
                               autotune=True)
    assert not ops._BLOCK_CACHE and not ops._TUNED_KEYS
    assert not fresh_cache.exists()


def test_table_path_names_the_card_and_the_switch_names_the_file(
        monkeypatch, tmp_path):
    """``REPRO_TORCH_AUTOTUNE_TABLE`` names the file (empty: none); else
    the table lies under ``.cache`` and needs the card's architecture, so
    without an initialized card there is none; the reference's
    ``REPRO_AUTOTUNE_TABLE`` is never read."""
    monkeypatch.setenv("REPRO_AUTOTUNE_TABLE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", "")
    assert ops._autotune_table_path() is None
    assert ops.save_autotune_table() is None
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_TABLE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (9, 0))
    path = ops._autotune_table_path()
    assert path.endswith(".cache/autotune-cuda-sm90.json")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert ops._autotune_table_path() is None


def test_fused_launcher_takes_and_checks_a_tile(monkeypatch):
    """``crossbar_train_kernel`` takes ``tile=`` as its siblings do and
    refuses an unknown index before the device."""
    def no_device_rule(name, t, like, dtypes=(torch.float32,)):
        if t.dtype not in dtypes:
            raise TypeError(name)

    launched = []
    monkeypatch.setattr(xbk, "_check_operand", no_device_rule)
    monkeypatch.setattr(xbk, "_run", lambda name, dev, *args:
                        launched.append(args[-5]))
    gp, gm = torch.ones(2, 6, 4), torch.zeros(2, 6, 4)
    x, d = torch.ones(2, 8, 6), torch.ones(2, 8, 4)
    for tile in (-1, len(xbk.OUTER_PRODUCT_TILES)):
        with pytest.raises(ValueError, match="OUTER_PRODUCT_TILES"):
            xbk.crossbar_train_kernel(gp, gm, x, d, lr=0.1, tile=tile)
    xbk.crossbar_train_kernel(gp, gm, x, d, lr=0.1, tile=1)
    xbk.crossbar_train_kernel(gp, gm, x, d, lr=0.1)
    assert launched == [1, xbk.outer_product_tile(2, 8, 6, 4, 4)]
