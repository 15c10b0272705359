"""Port parity: the LM server's decode step (``runtime.serve_loop``'s
``DecodeStep``, one captured CUDA graph per ``BatchedServer`` on the card,
``decode_fn`` itself on the CPU) in all six LM families, at the reduced
configs the family tests build, against ``repro``'s jitted ``decode_fn``
and ``BatchedServer``, with the port's ``model.init`` parameters (seed 0)
carried to the reference by ``interop.lm_params_to_numpy``.

What the card's graph rests on, shown here on the CPU:
- the step's length is a 0-d int32 tensor on the device (the reference's
  ``jnp.int32(step)``), and ``decode_fn`` gives the same bits for it as
  for the Python int;
- a decode step traced under ``FakeTensorMode`` with a tensor length makes
  no data-dependent host read (which would fail a capture or freeze a
  value into it);
- the capture rules of ``DecodeStep`` (one capture; a new capture for a
  replaced cache leaf, another parameter tensor or another batch shape;
  one ``ROUTING`` record a MoE layer a step), with a CPU stand-in for
  ``graphs.Graph`` that re-runs the captured body at each replay, reading
  the tensors it captured, as a graph does.

Tolerances, each the bar of the family's own decode test (float32
compute): logits within 1e-4 absolute plus relative (qwen2-0.5b,
recurrentgemma-9b, the MoE configs, seamless-m4t-medium and qwen2-vl-72b),
1e-5 for mamba2-130m.  Served tokens equal the reference server's, except
where a slot's first difference lies at a near-tie of the reference's
logits (top-2 gap within 1e-4 with a float32 cache, 1e-2 with a bf16 one,
the bar of ``tests/test_torch_lm.py``); the slot's later tokens are then
excused (counted).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import (  # noqa: E402
    DataDependentOutputException, FakeTensorMode)

from repro.configs import base as jcfg  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import graphs, interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

ARCHS = ["qwen2-0.5b", "recurrentgemma-9b", "moonshot-v1-16b-a3b",
         "qwen3-moe-30b-a3b", "mamba2-130m", "seamless-m4t-medium",
         "qwen2-vl-72b"]
MOE = ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"]
ENCDEC = "seamless-m4t-medium"
BAR = {arch: 1e-4 for arch in ARCHS} | {"mamba2-130m": 1e-5}
TIE = {"float32": 1e-4, "bfloat16": 1e-2}
SRC = 32                                 # encoder frames of the cross cache
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(3)]


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference model with a jitted decode_fn, its params, port model on
    the CPU, the same params as tensors), float32 compute.  The port's
    ``init`` draws the parameters (seed 0) and ``interop`` carries them to
    the reference: the reference's eager ``init`` of seven models would
    take most of this file's time."""
    jm = jbuild(jcfg.get_reduced_config(arch, compute_dtype="float32"))
    jm = dataclasses.replace(jm, decode_fn=jax.jit(jm.decode_fn))
    tm = tbuild(tcfg.get_reduced_config(arch, compute_dtype="float32"),
                "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, interop.lm_params_to_numpy(tp))
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    return jm, jp, tm, tp


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, L),
                                                dtype=np.int32)


def _frames(B, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (B, SRC, 64)).astype(np.float32)


def _jcache(arch, B, max_len, dtype):
    """The reference's cache, an encoder-decoder's cross cache filled from
    ``_frames``."""
    jm, jp, _, _ = _models(arch)
    if arch != ENCDEC:
        return jm.init_cache(B, max_len, dtype)
    cache = jm.init_cache(B, max_len, dtype, src_len=SRC)
    enc = jed.encode(jm.cfg, jp, jnp.asarray(_frames(B)))
    cache["cross"] = jed.fill_cross_cache(jm.cfg, jp, enc, dtype)
    return cache


def _cross(B, dtype, seed=5):
    _, _, tm, tp = _models(ENCDEC)
    enc = ted.encode(tm.cfg, tp, torch.from_numpy(_frames(B, seed)))
    return ted.fill_cross_cache(tm.cfg, tp, enc, dtype)


def _tcache(arch, B, max_len, dtype):
    """The port's cache, as ``_jcache``."""
    _, _, tm, _ = _models(arch)
    if arch != ENCDEC:
        return tm.init_cache(B, max_len, dtype)
    cache = tm.init_cache(B, max_len, dtype, src_len=SRC)
    cache["cross"] = _cross(B, dtype)
    return cache


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.reshape(-1).view(torch.uint8)
         == b.reshape(-1).view(torch.uint8)).all())


def _trees_equal(a, b) -> bool:
    la, lb = tshd.tree_leaves(a), tshd.tree_leaves(b)
    return len(la) == len(lb) and all(_bits_equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the length: a 0-d int32 tensor on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_length_equals_int_and_the_reference(arch):
    """3 decode steps: ``decode_fn`` with ``length`` a 0-d int32 tensor
    gives the logits and cache of the Python int bit for bit, and the
    reference's jitted ``decode_fn`` within the family's bar."""
    jm, jp, tm, tp = _models(arch)
    tok = _tokens(4, 3, 1)
    jc = _jcache(arch, 4, 16, jnp.float32)    # the server test's shapes
    c_int = _tcache(arch, 4, 16, torch.float32)
    c_ten = _tcache(arch, 4, 16, torch.float32)
    for step in range(3):
        b = tok[:, step:step + 1]
        want, jc = jm.decode_fn(jp, jc, {"tokens": jnp.asarray(b),
                                         "length": jnp.int32(step)})
        got, c_int = tm.decode_fn(tp, c_int, {"tokens": torch.from_numpy(b),
                                              "length": step})
        got_t, c_ten = tm.decode_fn(tp, c_ten, {
            "tokens": torch.from_numpy(b),
            "length": torch.tensor(step, dtype=torch.int32)})
        assert _bits_equal(got_t, got), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=BAR[arch], rtol=BAR[arch],
                                   err_msg=f"step {step}")
    assert _trees_equal(c_ten, c_int)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_makes_no_host_read(arch):
    """``decode_fn`` traced under ``FakeTensorMode`` (the dry run's
    ``input_specs``: the length a 0-d int32 tensor) reads nothing back to
    the host; a step that does raises under the same trace."""
    _, _, tm, _ = _models(arch)
    batch_spec, cache_spec = tm.input_specs("decode", 16, 2)
    assert batch_spec["length"] == ((), torch.int32)
    params_abs = tm.abstract_params()

    def trace(step):
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = dryrun._fake_like(params_abs)
            cache = dryrun._fake_like(dryrun._specs_to_meta(cache_spec))
            batch = dryrun._fake_like(dryrun._specs_to_meta(batch_spec))
            return step(params, cache, batch)

    logits, _ = trace(tm.decode_fn)
    assert tuple(logits.shape) == (2, 1, tm.cfg.padded_vocab)

    def reading(params, cache, batch):
        int(batch["length"])
        return tm.decode_fn(params, cache, batch)

    with pytest.raises(DataDependentOutputException):
        trace(reading)


# ---------------------------------------------------------------------------
# the server against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_equal_the_reference(arch, cache):
    """``BatchedServer`` (batch 4, one padded slot, 8-token prompts, 4 new
    tokens: 11 steps) against the reference's server on the same caches:
    the same stats, the same tokens but at counted near-ties, and no
    capture on the CPU."""
    jm, jp, tm, tp = _models(arch)
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=16,
                              cache_dtype=getattr(jnp, cache))
    js.cache = _jcache(arch, 4, 16, getattr(jnp, cache))
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=16,
                              cache_dtype=getattr(torch, cache))
    ts.cache = _tcache(arch, 4, 16, getattr(torch, cache))
    ref_logits = []
    jstep = jm.decode_fn          # jitted once per cache dtype for the file

    def recording(p, c, b):
        logits, c = jstep(p, c, b)
        ref_logits.append(np.asarray(logits[:, -1], np.float32))
        return logits, c

    js.decode = recording
    want = js.generate(PROMPTS, 4)
    got = ts.generate(PROMPTS, 4)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.steps == 11 and ts.captures == 0
    excused = 0
    for slot, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                row = np.sort(ref_logits[7 + i][slot])
                assert row[-1] - row[-2] <= TIE[cache], (slot, i)
                excused += len(g) - i
                break
    assert excused <= 4, (got, want)
    print(f"{arch} / {cache} cache: {excused} of 12 tokens excused")


def test_cpu_server_never_captures():
    """On the CPU ``DecodeStep`` calls ``decode_fn``: no graph, no capture,
    across two ``generate`` calls; the step's length reaches ``decode_fn``
    as a 0-d int32 tensor."""
    _, _, tm, tp = _models("qwen2-0.5b")
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=32)
    lengths = []
    step = ts.decode

    def recording(p, c, b):
        lengths.append(b["length"])
        return step(p, c, b)

    ts.decode = recording
    ts.generate(PROMPTS, 2)
    ts.generate(PROMPTS, 2)
    assert ts.captures == 0 and ts.step.graph is None
    assert not ts.step.compiled and ts.step.pool_bytes() is None
    assert [int(t) for t in lengths] == list(range(9)) * 2
    assert all(t.dtype == torch.int32 and t.dim() == 0 for t in lengths)


@pytest.mark.parametrize("arch", MOE)
def test_routing_gets_one_record_per_moe_layer_per_step(arch):
    """``layers.moe.ROUTING`` over a served session: one ``Routing`` a MoE
    layer a step, as eager decode leaves it."""
    _, _, tm, tp = _models(arch)
    n_moe = tm.cfg.layer_kinds().count("moe")
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=16)
    tmoe.ROUTING = []
    try:
        ts.generate(PROMPTS, 3)
        routes = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    assert n_moe > 0 and len(routes) == ts.stats.steps * n_moe == 10 * n_moe
    assert all(r.top_i.shape[:2] == (1, 4) for r in routes)


# ---------------------------------------------------------------------------
# the capture rules, with a CPU stand-in for the graph
# ---------------------------------------------------------------------------

class ReplayOnCpu:
    """``graphs.Graph``'s contract on the CPU: the warm-up runs the body
    (its result is the call's); the capture executes nothing; a replay
    runs the body again on the tensors it captured, returning its outputs,
    and leaves no record of its own (``ROUTING`` closed meanwhile), as a
    replay runs no Python."""

    def __init__(self, body, device):
        self.body = body
        self.per_replay: dict = {}

    def warm_up(self):
        return self.body()

    def capture(self):
        pass

    def replay(self):
        saved, tmoe.ROUTING = tmoe.ROUTING, None
        try:
            return self.body()
        finally:
            tmoe.ROUTING = saved

    def pool_bytes(self):
        return 0


@pytest.fixture
def captured_step(monkeypatch):
    """A ``DecodeStep`` of the encoder-decoder on the CPU that captures,
    through the stand-in."""
    monkeypatch.setattr(graphs, "Graph", ReplayOnCpu)
    _, _, tm, tp = _models(ENCDEC)
    step = tserve.DecodeStep(tm.decode_fn, torch.device("cpu"))
    step.compiled = True
    return tm, tp, step


def _feed(step, tok):
    return {"tokens": torch.from_numpy(tok[:, step:step + 1]),
            "length": torch.tensor(step, dtype=torch.int32)}


def test_replaced_cross_cache_is_the_one_the_next_step_reads(captured_step):
    """A cross cache set after the capture (as ``chip_smoke.py`` and the
    encoder-decoder tests set ``server.cache["cross"]``) takes a new
    capture: the next step reads it, equal bit for bit to an eager run
    that had it from the start, and the steps after it replay."""
    tm, tp, step = captured_step
    tok = _tokens(2, 4, 2)
    cache = tm.init_cache(2, 8, torch.float32, src_len=SRC)
    _, cache = step(tp, cache, _feed(0, tok))
    cache["cross"] = _cross(2, torch.float32)
    eager = tm.init_cache(2, 8, torch.float32, src_len=SRC)
    tm.decode_fn(tp, eager, _feed(0, tok))
    eager["cross"] = _cross(2, torch.float32)
    for s in range(1, 4):
        got, cache = step(tp, cache, _feed(s, tok))
        want, eager = tm.decode_fn(tp, eager, _feed(s, tok))
        assert _bits_equal(got, want), s
        assert step.captures == 2, s
    assert _trees_equal(cache, eager)
    stale = tm.init_cache(2, 8, torch.float32, src_len=SRC)
    for s in range(4):
        zero, stale = tm.decode_fn(tp, stale, _feed(s, tok))
    assert not torch.allclose(got, zero)        # the zero cross differs


def test_new_shapes_and_parameters_capture_again(captured_step):
    """Only the captured tensors and batch shapes replay: a whole new
    cache, a cross cache of another source length, another parameter
    tensor, int64 tokens and an int64 length each take a new capture,
    counted; the captured inputs again replay."""
    tm, tp, step = captured_step
    tok = _tokens(2, 8, 4)
    cache = tm.init_cache(2, 8, torch.float32, src_len=SRC)
    _, cache = step(tp, cache, _feed(0, tok))
    _, cache = step(tp, cache, _feed(1, tok))
    assert step.captures == 1
    cache = tm.init_cache(2, 8, torch.float32, src_len=SRC)
    _, cache = step(tp, cache, _feed(2, tok))
    assert step.captures == 2
    cache["cross"] = tm.init_cache(2, 8, torch.float32,
                                   src_len=SRC // 2)["cross"]
    _, cache = step(tp, cache, _feed(3, tok))
    assert step.captures == 3
    tp2 = tshd.tree_map(lambda a: a.clone(), tp)
    _, cache = step(tp2, cache, _feed(4, tok))
    assert step.captures == 4
    wide = _feed(5, tok)
    _, cache = step(tp2, cache, wide | {"tokens": wide["tokens"].long()})
    assert step.captures == 5
    _, cache = step(tp2, cache, _feed(6, tok) | {
        "length": torch.tensor(6, dtype=torch.int64)})
    assert step.captures == 6
    _, cache = step(tp2, cache, _feed(7, tok) | {
        "length": torch.tensor(7, dtype=torch.int64)})
    assert step.captures == 6                   # the same shapes replay


@pytest.mark.parametrize("arch", MOE)
def test_replays_keep_one_routing_record_per_moe_layer(arch, monkeypatch):
    """Through the stand-in graph: the capture's ``ROUTING`` records leave
    the list and each replay appends clones of them, so a served session
    leaves one ``Routing`` a MoE layer a step, as eager decode.  Here the
    capture runs the body's Python, as a capture does, and then puts the
    cache back (a capture executes nothing)."""
    state: list = []

    class Capturing(ReplayOnCpu):
        def capture(self):
            saved = [t.clone() for t in state]
            self.body()
            for t, v in zip(state, saved):
                t.copy_(v)

    monkeypatch.setattr(graphs, "Graph", Capturing)
    _, _, tm, tp = _models(arch)
    n_moe = tm.cfg.layer_kinds().count("moe")
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=16)
    state.extend(tshd.tree_leaves(ts.cache))
    ts.step.compiled = True
    tmoe.ROUTING = []
    try:
        ts.generate(PROMPTS, 3)
        routes = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    assert ts.captures == 1
    assert n_moe > 0 and len(routes) == ts.stats.steps * n_moe == 10 * n_moe
    assert all(r.top_i.shape[:2] == (1, 4) for r in routes)
    assert routes[n_moe].top_i is not routes[2 * n_moe].top_i
