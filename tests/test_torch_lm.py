"""Port parity: the LM serving path of ``repro_torch`` (configs, model,
``BatchedServer``, the serve CLI) against ``repro``'s on the reduced
qwen2-0.5b config (2 layers, d_model 64), with the reference's
``model.init(PRNGKey(0))`` parameters carried across by
``interop.lm_params_from_numpy``.

Tolerances, each with its reason:
- logits in float32 compute: 1e-4 absolute plus relative (fp32 sums in
  different orders through two layers; the bf16 KV cache of a decode step
  rounds identical values on both sides).
- logits in bf16 compute: 1e-2 absolute plus relative.  The two
  frameworks round bf16 products and activations at the same places
  (prefill attention included: the port's ``chunked_attention`` rounds p
  to bf16 as the reference's does) but sum in different orders; measured
  (CPU): 7.5e-3 for prefill, 5.6e-3 for decode (1.34x and 1.8x margin).
- greedy tokens: equal, except at a position whose top-2 logit gap is
  within the logit tolerance above; the slot's later tokens are then
  excused too (they follow a different feed).  Each test counts what it
  excused.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jcfg  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
DENSE = ["qwen2-0.5b", "yi-6b", "mistral-nemo-12b", "qwen1.5-110b"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(4)]


def _models(compute_dtype):
    """(reference model with jitted prefill/decode, its params, port model,
    the same params as tensors)."""
    jc = jcfg.get_reduced_config(ARCH, compute_dtype=compute_dtype)
    tc = tcfg.get_reduced_config(ARCH, compute_dtype=compute_dtype)
    jm, tm = jbuild(jc), tbuild(tc, "cpu")
    jm = dataclasses.replace(jm, prefill_fn=jax.jit(jm.prefill_fn),
                             decode_fn=jax.jit(jm.decode_fn))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return (request.param,) + _models(request.param)


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, L),
                                                dtype=np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_param_count_equal_the_reference(arch):
    for getter in ("get_config", "get_reduced_config"):
        jc = getattr(jcfg, getter)(arch)
        tc = getattr(tcfg, getter)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.padded_vocab == jc.padded_vocab
        assert tc.param_count() == jc.param_count()
        assert tc.attn() == tc.attn(None)
        # every field of the port's AttnConfig (chunked_attention's
        # tiling included) equals the reference's
        ja = dataclasses.asdict(jc.attn())
        assert dataclasses.asdict(tc.attn()) == {
            f.name: ja[f.name] for f in dataclasses.fields(tc.attn())}
    # the layer's scale is the reference flash wrapper's hd ** -0.5 for
    # every ported config, in the fp32 that the kernel multiplies by
    cfg = tcfg.get_config(arch)
    assert np.float32(cfg.attn().scale) == np.float32(cfg.head_dim ** -0.5)


def test_registry_lists_only_what_the_port_builds():
    assert sorted(tcfg.list_archs()) == sorted(
        DENSE + ["recurrentgemma-9b", "moonshot-v1-16b-a3b",
                 "qwen3-moe-30b-a3b", "mamba2-130m", "seamless-m4t-medium",
                 "qwen2-vl-72b"])
    assert tcfg.SHAPES == jcfg.SHAPES
    cfg = tcfg.get_config("qwen2-0.5b")
    assert tcfg.shape_applicable(cfg, "long_500k")[0] is False
    assert cfg.padded_vocab - cfg.vocab_size == 128
    assert cfg.param_count() == 494147456
    assert tcfg.get_config("seamless-m4t-medium").param_count() == 878309376
    assert tcfg.get_config("qwen2-vl-72b").param_count() == 72773312512
    # the port builds every reference architecture
    assert set(jcfg.list_archs()) - set(tcfg.list_archs()) == set()


def test_unported_kinds_and_families_raise():
    cfg = tcfg.get_reduced_config(ARCH)
    # local (windowed) blocks are ported (tests/test_torch_hybrid.py), and
    # so are moe blocks (tests/test_torch_moe.py) and ssd blocks
    # (tests/test_torch_ssd.py), alone or after an attention block
    tbuild(cfg.replace(block_pattern=("attn", "local"), window=8), "cpu")
    for pattern in (("ssd",), ("attn", "ssd")):
        sm = tbuild(cfg.replace(block_pattern=pattern, ssm_state=16,
                                ssm_head_dim=16, ssm_chunk=8), "cpu")
        sp = sm.init(torch.Generator().manual_seed(0))
        key = f"b{len(pattern) - 1}_ssd"
        assert set(sp["stack"][key]) == {"ln", "ssd"}
        zeros = torch.zeros(1, 8, dtype=torch.int32)
        loss, metrics = sm.loss_fn(sp, {"tokens": zeros, "labels": zeros})
        assert bool(torch.isfinite(loss)) and float(metrics["aux"]) == 0
    moe = cfg.replace(block_pattern=("attn", "moe"), n_experts=4, top_k=2,
                      d_expert=32)
    tm = tbuild(moe, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    assert set(tp["stack"]["b1_moe"]) == {"ln1", "attn", "ln2", "moe"}
    zeros = torch.zeros(1, 8, dtype=torch.int32)
    _, metrics = tm.loss_fn(tp, {"tokens": zeros, "labels": zeros})
    assert float(metrics["aux"].detach()) > 0
    # VLM patches are ported (tests/test_torch_vlm.py): the merger is a
    # plain dense layer; an unknown block kind still raises
    vm = tbuild(cfg.replace(vlm_patches=4), "cpu")
    vp = vm.init(torch.Generator().manual_seed(0))
    assert "patch_merger" in vp and set(vp["patch_merger"]) == {"w"}
    loss, _ = vm.loss_fn(vp, {"tokens": zeros, "labels": zeros,
                              "patch_embeds": torch.ones(1, 4, 64)})
    assert bool(torch.isfinite(loss))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tbuild(cfg.replace(block_pattern=("attn", "conv")), "cpu")
    # the encoder-decoder family builds (tests/test_torch_encdec.py holds
    # it against the reference): an encoder and a decoder stack, a loss
    # without an aux term
    em = tbuild(cfg.replace(family="encdec", encoder_layers=1), "cpu")
    ep = em.init(torch.Generator().manual_seed(0))
    assert set(ep) == {"src_proj", "embed", "encoder", "enc_norm",
                       "decoder", "final_norm", "lm_head"}
    loss, metrics = em.loss_fn(ep, {"src_frames": torch.zeros(1, 8, 64),
                                    "tgt_tokens": zeros, "labels": zeros})
    assert bool(torch.isfinite(loss)) and set(metrics) == {"ce"}


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_reduced_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced"])
    with pytest.raises(ValueError, match="generator"):
        tbuild(cfg, "meta").init(torch.Generator())


# ---------------------------------------------------------------------------
# params: spec, init, interop
# ---------------------------------------------------------------------------

def test_param_tree_matches_and_round_trips(models):
    _, jm, jp, tm, tp = models
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tshd.tree_leaves(tp)
    assert len(jleaves) == len(tleaves) > 0
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
    back = interop.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    tshd.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert tp["prefix"] == () and tp["suffix"] == ()
    assert tp["stack"]["b0_attn"]["attn"]["wq"]["w"].shape == (2, 64, 64)


def test_port_init_draws_every_leaf_on_its_generator():
    tm = tbuild(tcfg.get_reduced_config(ARCH), "cpu")
    a = tm.init(torch.Generator().manual_seed(0))
    b = tm.init(torch.Generator().manual_seed(0))
    c = tm.init(torch.Generator().manual_seed(1))
    for x, y, z in zip(*(tshd.tree_leaves(t) for t in (a, b, c))):
        assert torch.equal(x, y)
    w = a["stack"]["b0_attn"]["attn"]["wq"]["w"]
    assert not torch.equal(w[0], w[1])                 # layers independent
    assert not torch.equal(w, c["stack"]["b0_attn"]["attn"]["wq"]["w"])
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    table = a["embed"]["table"]
    assert abs(float(table.std()) - 0.02) < 1e-3


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

def test_prefill_matches_the_reference(models):
    dtype, jm, jp, tm, tp = models
    tok = _tokens(2, 64)
    want = jm.prefill_fn(jp, {"tokens": jnp.asarray(tok)})
    before = tops.flash_attention.launches
    got = tm.prefill_fn(tp, {"tokens": torch.from_numpy(tok)})
    assert tops.flash_attention.launches == before     # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (2, 64, 512)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_decode_matches_the_reference(models, cache_dtype):
    dtype, jm, jp, tm, tp = models
    jd, td = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jc = jm.init_cache(2, 16, jd)
    tc = tm.init_cache(2, 16, td)
    buffers = [t.data_ptr() for t in tshd.tree_leaves(tc)]
    tok = _tokens(2, 6, 1)
    tol = LOGIT_TOL[dtype] if cache_dtype == "bfloat16" else 2e-2
    for step in range(6):
        b = tok[:, step:step + 1]
        want, jc = jm.decode_fn(jp, jc, {"tokens": jnp.asarray(b),
                                         "length": jnp.int32(step)})
        got, tc_out = tm.decode_fn(tp, tc, {"tokens": torch.from_numpy(b),
                                            "length": step})
        assert tc_out is tc
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol, err_msg=f"step {step}")
    assert [t.data_ptr() for t in tshd.tree_leaves(tc)] == buffers
    np.testing.assert_array_equal(tc["stack"]["b0_attn"]["length"].numpy(),
                                  np.asarray(jc["stack"]["b0_attn"]["length"]))
    np.testing.assert_array_equal(tc["stack"]["b0_attn"]["pos"].numpy(),
                                  np.asarray(jc["stack"]["b0_attn"]["pos"]))


def test_decode_equals_prefill_in_the_port():
    """The port's own decode path (plain attention over the cache) against
    its prefill path (the flash kernel's plain version), float32 compute
    and a float32 cache: the same function, summed in other orders."""
    cfg = tcfg.get_reduced_config(ARCH, compute_dtype="float32")
    tm = tbuild(cfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(3))
    tok = torch.from_numpy(_tokens(3, 20, 2))
    want = tm.prefill_fn(tp, {"tokens": tok})
    cache = tm.init_cache(3, 32, torch.float32)
    for step in range(20):
        got, cache = tm.decode_fn(tp, cache, {"tokens": tok[:, step:step + 1],
                                              "length": step})
        torch.testing.assert_close(got[:, 0], want[:, step], atol=1e-5,
                                   rtol=1e-5)


def test_softcap_is_applied():
    cfg = tcfg.get_reduced_config(ARCH)
    tp = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tok = {"tokens": torch.from_numpy(_tokens(1, 8))}
    plain = tbuild(cfg, "cpu").prefill_fn(tp, tok)
    capped = tbuild(cfg.replace(logits_softcap=0.05), "cpu").prefill_fn(
        tp, tok)
    torch.testing.assert_close(capped, torch.tanh(plain / 0.05) * 0.05,
                               atol=0, rtol=0)
    assert float(capped.abs().max()) <= np.float32(0.05)


def test_input_specs():
    tm = tbuild(tcfg.get_reduced_config(ARCH), "cpu")
    assert tm.input_specs("prefill", 64, 2) == \
        {"tokens": ((2, 64), torch.int32)}
    batch, cache = tm.input_specs("decode", 64, 2)
    assert batch["length"] == ((), torch.int32)
    assert cache["stack"]["b0_attn"]["k"] == ((2, 2, 64, 2, 16),
                                              torch.bfloat16)
    jm = jbuild(jcfg.get_reduced_config(ARCH))
    _, jcache = jm.input_specs("decode", 64, 2)
    assert jcache["stack"]["b0_attn"]["k"].shape == (2, 2, 64, 2, 16)


# ---------------------------------------------------------------------------
# the server against the reference's
# ---------------------------------------------------------------------------

def _excused(jm, jp, prompt, got, want, tol):
    """Positions of one slot whose tokens differ: the first difference
    must be a near-tie of the reference's logits (top-2 gap <= tol); it
    and the slot's later tokens are excused.  Returns how many."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            seq = jnp.asarray([prompt + want[:i]], jnp.int32)
            row = np.sort(np.asarray(jm.prefill_fn(jp, {"tokens": seq}),
                                     np.float32)[0, -1])
            assert row[-1] - row[-2] <= tol, (i, row[-1] - row[-2])
            return len(got) - i
    return 0


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_batched_server_matches_the_reference(models, cache_dtype):
    dtype, jm, jp, tm, tp = models
    prompts = PROMPTS[:3]                     # one padded slot
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=32,
                              cache_dtype=getattr(jnp, cache_dtype))
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=32,
                              cache_dtype=getattr(torch, cache_dtype))
    want = js.generate(prompts, 8)
    got = ts.generate(prompts, 8)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    # the padded slot generates too and is counted, as in the reference
    assert ts.stats.steps == 15 and ts.stats.tokens_out == 32
    assert len(got) == 3 and all(len(o) == 8 for o in got)
    tol = LOGIT_TOL[dtype] if cache_dtype == "bfloat16" else 2e-2
    excused = sum(_excused(jm, jp, p, g, w, tol)
                  for p, g, w in zip(prompts, got, want))
    assert excused <= 8, (got, want)   # at most one slot left a near-tie
    print(f"{dtype} / {cache_dtype} cache: {excused} of 24 tokens excused")


def test_batched_server_refuses_more_prompts_than_slots():
    tm = tbuild(tcfg.get_reduced_config(ARCH), "cpu")
    ts = tserve.BatchedServer(tm, tm.init(torch.Generator().manual_seed(0)),
                              batch=2, max_len=16)
    with pytest.raises(ValueError, match="3 prompts"):
        ts.generate(PROMPTS[:3], 2)


def test_request_queue_contract():
    for mod in (tserve, jserve):
        q = mod.RequestQueue(["a", "b"])
        assert q.submit("c") == 2 and q.submitted == 3
        assert [r.x for r in q.pending] == ["a", "b", "c"]
        first = q.pop()
        assert first == mod.Request(0, "a") and not q.drained
        q.complete(first.rid, "A")
        with pytest.raises(ValueError, match="completed twice"):
            q.complete(first.rid, "A")
        r2, r3 = q.pop(), q.pop()
        assert q.pop() is None
        q.complete(r3.rid, "C")
        q.complete(r2.rid, "B")
        assert q.drained and q.completed == 3
        assert q.results() == ["A", "B", "C"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--max-new", "4"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "16 tokens in" in lines[-1] and "(11 decode steps)" in lines[-1]


def test_serve_cli_refuses_checkpoints(tmp_path):
    # checkpoints are ported: the CLI serves what a checkpoint restores
    # (tests/test_torch_train_loop.py) and refuses a directory without one
    from repro_torch.launch import serve
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
