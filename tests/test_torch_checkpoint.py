"""Port parity: ``repro_torch.runtime.checkpoint`` and the trainer's
preempt-and-resume against ``repro.runtime.checkpoint``'s statements
(after ``tests/test_checkpoint.py``, its single-device part): the
roundtrip (also onto a mesh's shardings), ``keep_last``, atomic writes, a
bit-for-bit resume, and one on-disk layout that each package restores
from the other.

Tolerances: none.  A checkpoint stores arrays whole and restores them
exactly; a resumed run replays the same float32 operations on the same
values and data, so it equals the uninterrupted run bit for bit.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced_config as jreduced  # noqa: E402
from repro.data.pipeline import TokenStream as JStream  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist.sharding import (NamedSharding,  # noqa: E402
                                       PartitionSpec, tree_leaves, tree_map)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Trainer, checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.faults import (FaultInjector,  # noqa: E402
                                        SimulatedPreemption)


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "t": (torch.zeros(2), {"d": torch.full((1,), 7.0)}),
            "none": None}
    path = ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000007"
    like = tree_map(lambda a: torch.empty(a.shape, device="meta"),
                    {k: v for k, v in tree.items() if k != "none"})
    like["none"] = None
    restored, step, extra = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 7 and extra == {"note": "x"}
    assert restored["none"] is None
    for got, want in zip(tree_leaves({k: v for k, v in restored.items()
                                      if k != "none"}),
                         tree_leaves({k: v for k, v in tree.items()
                                      if k != "none"})):
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(str(tmp_path), {"a": torch.empty(4, 3)}, device="cpu")
    # onto shardings: each leaf on its sharding's device, the values equal
    mesh = make_host_mesh(device="cpu")
    rep = NamedSharding(mesh, PartitionSpec())
    shards = tree_map(lambda _: rep, {k: v for k, v in like.items()
                                      if k != "none"})
    shards["none"] = None
    placed, step, _ = ckpt.restore(str(tmp_path), like, shardings=shards)
    assert step == 7 and placed["none"] is None
    for got, want in zip(tree_leaves({k: v for k, v in placed.items()
                                      if k != "none"}),
                         tree_leaves({k: v for k, v in tree.items()
                                      if k != "none"})):
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_keep_last_gc(tmp_path):
    tree = {"a": torch.zeros(2)}
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(str(tmp_path), tree, device="cpu")
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree, keep_last=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_a_failed_write_leaves_latest_as_it_was(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(3)})

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(str(tmp_path), 2, {"a": torch.zeros(3)})
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000001"]


def _trainer(cfg, d, injector=None):
    return Trainer(cfg, adamw(1e-3), ckpt_dir=d, ckpt_every=3,
                   fault_injector=injector, seed=0, device="cpu")


def test_resume_is_bitwise_identical(tmp_path):
    """Preempt at step 6 (after the checkpoint at 6), restart, and the
    final state equals an uninterrupted run's bit for bit."""
    cfg = get_reduced_config("qwen2-0.5b")
    stream = TokenStream(cfg.vocab_size, 32, 4, seed=3)
    ref_state, ref_hist = _trainer(cfg, str(tmp_path / "ref")).run(
        stream, 9, log_every=100)
    with pytest.raises(SimulatedPreemption):
        _trainer(cfg, str(tmp_path / "int"),
                 FaultInjector(preempt_at_step=6)).run(stream, 9,
                                                       log_every=100)
    assert ckpt.latest_step(str(tmp_path / "int")) == 6
    state, hist = _trainer(cfg, str(tmp_path / "int")).run(
        stream, 9, log_every=100)
    assert state.step == ref_state.step == 9
    assert [h["step"] for h in hist] == [7, 8, 9]
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[6:]]
    for a, b in zip(tree_leaves(state.params), tree_leaves(ref_state.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(state.opt_state),
                    tree_leaves(ref_state.opt_state)):
        assert torch.equal(a, b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the reference's trainer wrote restores into the port's
    trainer: same keys, same arrays, and the port resumes from its step."""
    d = str(tmp_path)
    jcfg = jreduced("qwen2-0.5b")
    jstate, _ = JTrainer(jcfg, jadamw(1e-3), ckpt_dir=d, ckpt_every=2,
                         seed=0).run(JStream(jcfg.vocab_size, 16, 2, seed=1),
                                     2, log_every=100)
    cfg = get_reduced_config("qwen2-0.5b")
    trainer = _trainer(cfg, d)
    state = trainer.restore_or_init()
    assert state.step == 2
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                {"params": jstate.params, "opt": jstate.opt_state})[0]}
    got = {}
    for prefix, tree in (("params", state.params), ("opt", state.opt_state)):
        for path, t in ckpt._walk(tree):
            got[ckpt._key((prefix,) + path)] = t.numpy()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    state, hist = trainer.run(TokenStream(cfg.vocab_size, 16, 2), 3,
                              log_every=100)
    assert state.step == 3 and [h["step"] for h in hist] == [3]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    cfg = get_reduced_config("qwen2-0.5b")
    state, _ = Trainer(cfg, adamw(1e-3), ckpt_dir=d, ckpt_every=2,
                       device="cpu").run(TokenStream(cfg.vocab_size, 16, 2),
                                         2, log_every=100)
    jcfg = jreduced("qwen2-0.5b")
    jtrainer = JTrainer(jcfg, jadamw(1e-3), ckpt_dir=d, seed=0)
    jstate = jtrainer.restore_or_init()
    assert jstate.step == 2
    got = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(
               {"params": jstate.params, "opt": jstate.opt_state})[0]}
    want = {}
    for prefix, tree in (("params", state.params), ("opt", state.opt_state)):
        for path, t in ckpt._walk(tree):
            want[ckpt._key((prefix,) + path)] = t.numpy()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        assert '"arch": "qwen2-0.5b-reduced"' in f.read()
    # and the reference's own restore of the raw tree agrees
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        jstate.params)
    raw, step, extra = jckpt.restore(d, {"params": like, "opt": None})
    assert step == 2 and extra == {"arch": "qwen2-0.5b-reduced"}
    for a, b in zip(jax.tree.leaves(raw["params"]),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
