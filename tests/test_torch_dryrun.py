"""The port's dry run (``repro_torch.launch.dryrun``, ``sweep`` and
``report``) against the reference's (``repro.launch.dryrun``).

The reference's dry run sets ``XLA_FLAGS`` for 512 host devices when it is
imported, so it is never imported here: one subprocess per module
(``REF_CODE``, started before the first test and read when needed)
lowers the reduced cells with the reference's ``_lower_one`` on 8 host
devices, compiles them four at a time and writes the reference's figures
as JSON.  Its backend optimization level is 0, which leaves every figure
read here unchanged (argument sizes and ``cost_analysis`` FLOPs equal
those at the default level) and halves its compile time; the port's
traces run meanwhile, the sweep's subprocess after it.

Held here: per-device ``memory.argument`` equals the reference's
``argument_size_in_bytes`` exactly (reduced qwen2-0.5b prefill, train and
decode on one device and on a (4, 2) mesh; one reduced config of each
other family's prefill on the (4, 2) mesh, mamba2-130m's on (1, 4, 2)
with its "pod" axis); ``_cache_pspec`` gives the reference's spec for
every decode-cache leaf of every architecture on the production meshes;
the traced FLOPs are within 25 % of the reference's ``cost_analysis()``
FLOPs (unrolled layers, no accumulation) for every family's reduced
prefill and the dense train step; the parameter collectives of a
two-leaf spec tree, counted by hand; and one real sweep cell rendered by
the report.
"""
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402
from repro_torch.configs import (SHAPES, get_config,  # noqa: E402
                                 get_reduced_config, list_archs)
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import report, sweep  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import _map_with_path  # noqa: E402

SEQ, BATCH = 64, 8
FAMILIES = {"dense": "qwen2-0.5b", "hybrid": "recurrentgemma-9b",
            "moe": "moonshot-v1-16b-a3b", "ssm": "mamba2-130m",
            "encdec": "seamless-m4t-medium", "vlm": "qwen2-vl-72b"}
# (arch, kind, mesh): "1" one device with unrolled layers and no
# accumulation (its FLOPs are compared too), "42" the (4, 2) mesh
CELLS = ([(a, "prefill", m) for a in FAMILIES.values() for m in ("1", "42")]
         + [("qwen2-0.5b", k, m) for k in ("train", "decode")
            for m in ("1", "42")])
# the reference's figures for reduced qwen2-0.5b at seq 64, batch 8
TARGETS = {("qwen2-0.5b", "prefill", "1"): 430_336,
           ("qwen2-0.5b", "prefill", "42"): 55_552,
           ("qwen2-0.5b", "train", "1"): 1_288_964,
           ("qwen2-0.5b", "train", "42"): 165_124}
FLOPS_CELLS = [(a, "prefill") for a in FAMILIES.values()] + [
    ("qwen2-0.5b", "train")]
DECODE_SHAPES = ("decode_32k", "long_500k")

REF_CODE = f"""
import concurrent.futures, json, types
import jax
assert len(jax.devices()) == 8
import repro.launch.dryrun as dr
from repro.configs import SHAPES, get_config, get_reduced_config, list_archs
from repro.dist import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.models.model import build_model

out = {{"arg": {{}}, "flops": {{}}, "pspec": {{}}}}
# _lower_one lowers and compiles; its compile is deferred here so that
# the cells compile four at a time below
lowered, compile_ = {{}}, jax.stages.Lowered.compile
jax.stages.Lowered.compile = lambda self: self
for arch, kind, m in {CELLS!r}:
    cfg = get_reduced_config(arch)
    if m == "1":
        cfg = cfg.replace(unroll_layers=True, grad_accum=1)
    pod = arch == "mamba2-130m"
    axes = ("pod", "data", "model") if pod else ("data", "model")
    shape = {{"1": (1, 1), "42": (4, 2)}}[m]
    mesh = make_host_mesh(((1,) if pod else ()) + shape, axes)
    rules = shd.make_rules(mesh, dict(cfg.sharding_overrides or ()))
    lowered[(arch, kind, m)], *_ = dr._lower_one(cfg, kind, {SEQ}, {BATCH},
                                                 mesh, rules)
jax.stages.Lowered.compile = compile_
with concurrent.futures.ThreadPoolExecutor(4) as pool:
    done = dict(zip(lowered, pool.map(compile_, lowered.values())))
for (arch, kind, m), c in done.items():
    out["arg"]["|".join((arch, kind, m))] = \\
        c.memory_analysis().argument_size_in_bytes
    if m == "1":
        out["flops"][arch + "|" + kind] = float(c.cost_analysis()["flops"])
for arch in list_archs():
    cfg = get_config(arch)
    model = build_model(cfg)
    for multi in (False, True):
        axes = ("pod", "data", "model") if multi else ("data", "model")
        sizes = (2, 16, 16) if multi else (16, 16)
        mesh = types.SimpleNamespace(axis_names=axes,
                                     shape=dict(zip(axes, sizes)))
        rules = shd.make_rules(mesh, dict(cfg.sharding_overrides or ()))
        for name in {DECODE_SHAPES!r}:
            sh = SHAPES[name]
            _, cache = model.input_specs("decode", sh["seq_len"],
                                         sh["global_batch"])
            flat, _ = jax.tree_util.tree_flatten_with_path(cache)
            cell = {{}}
            try:
                for p, leaf in flat:
                    spec = dr._cache_pspec(p, leaf, mesh, rules,
                                           sh["global_batch"])
                    key = "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                                   for e in p)
                    cell[key] = [list(e) if isinstance(e, tuple) else e
                                 for e in spec]
            except KeyError as e:
                cell = "KeyError " + str(e)
            out["pspec"]["|".join((arch, str(multi), name))] = cell
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc():
    """The reference's side, started before this module's first test."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    p = subprocess.Popen([sys.executable, "-c", REF_CODE], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    yield p
    if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    out, err = ref_proc.communicate(timeout=300)
    assert ref_proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _mesh(arch, m):
    pod = arch == "mamba2-130m"
    axes = ("pod", "data", "model") if pod else ("data", "model")
    shape = {"1": (1, 1), "42": (4, 2)}[m]
    return make_host_mesh(((1,) if pod else ()) + shape, axes,
                          device="cpu")


_TRACES: dict = {}


def _trace(arch, kind, m):
    """The port's trace of a reduced cell, computed once per module."""
    key = (arch, kind, m)
    if key not in _TRACES:
        cfg = get_reduced_config(arch)
        if m == "1":
            cfg = cfg.replace(unroll_layers=True, grad_accum=1)
        mesh = _mesh(arch, m)
        rules = shd.make_rules(mesh, dict(cfg.sharding_overrides or ()))
        _TRACES[key] = dr._lower_one(cfg, kind, SEQ, BATCH, mesh, rules)[0]
    return _TRACES[key]


# ---------------------------------------------------------------------------
# Without the reference (its subprocess runs meanwhile)
# ---------------------------------------------------------------------------

def test_param_collectives_counted_by_hand():
    """A (64, 32) fp32 leaf on ("fsdp", "heads") of a (4, 2) mesh is
    sharded 8 ways (1,024 bytes a device); a (16,) leaf is replicated.
    Train under remat "full": the first is gathered three times (8,192
    bytes of result, group 8) and its gradient reduce-scattered once; the
    second's gradient is all-reduced over the 4 data devices.  Prefill:
    one gather."""
    mesh = make_host_mesh((4, 2), device="cpu")
    rules = shd.make_rules(mesh)
    init = shd.zeros_init()
    tree = {"w": shd.ParamSpec((64, 32), ("fsdp", "heads"), init),
            "b": shd.ParamSpec((16,), (None,), init)}
    train = dr.param_collectives(tree, rules, mesh, "train", "full")
    assert sorted(train) == sorted([("all-gather", 8192, 8)] * 3 + [
        ("reduce-scatter", 1024, 8), ("all-reduce", 64, 4)])
    assert dr.param_collectives(tree, rules, mesh, "prefill") == [
        ("all-gather", 8192, 8)]
    assert len(dr.param_collectives(tree, rules, mesh, "train", "none",
                                    grad_accum=2)) == 2 * 2 + 2
    coll = rl.collective_bytes(train, mesh.size)
    assert coll == {"all-gather": 3 * 8192 * 7 / 8,
                    "reduce-scatter": 1024 * 7, "all-reduce": 64 * 2 * 3 / 4,
                    "total": 3 * 8192 * 7 / 8 + 1024 * 7 + 64 * 2 * 3 / 4}


@pytest.mark.parametrize("arch,kind", [c[:2] for c in CELLS[::2]])
def test_argument_bytes_are_the_held_bytes(arch, kind):
    """On one device ``memory.argument`` is every argument's bytes (the
    parameters, the adamw state, the batch or the cache, and the train
    step's int32 step); on the (4, 2) mesh one device's share lies
    between an eighth of that and all of it."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, "cpu")
    held = shd.param_count(model.spec) * 4
    specs = model.input_specs(kind, SEQ, BATCH)
    for tree in (specs if kind == "decode" else (specs,)):
        held += sum(t.nbytes for t in shd.tree_leaves(dr._specs_to_meta(tree)))
    if kind == "train":
        held += 2 * shd.param_count(model.spec) * 4 + 4
    one, mesh = _trace(arch, kind, "1")["argument"], \
        _trace(arch, kind, "42")["argument"]
    assert one == held
    assert held / 8 <= mesh <= held


def test_trace_allocates_nothing_and_keeps_no_fake_constant():
    """A trace leaves the constant caches real: a CPU run afterwards
    computes as before."""
    from repro_torch.core.quantization import device_constant
    from repro_torch.layers.rope import _rope_freqs
    _trace("qwen2-0.5b", "prefill", "42")
    c = device_constant(0.25, torch.float32, torch.device("cpu"))
    f = _rope_freqs(64, 10000.0, torch.device("cpu"))
    assert type(c) is torch.Tensor and type(f) is torch.Tensor
    assert float(c * 4) == 1.0


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,m", CELLS)
def test_argument_bytes_equal_the_reference(ref, arch, kind, m):
    got = _trace(arch, kind, m)["argument"]
    assert got == ref["arg"]["|".join((arch, kind, m))]
    if (arch, kind, m) in TARGETS:
        assert got == TARGETS[(arch, kind, m)]


@pytest.mark.parametrize("arch,kind", FLOPS_CELLS)
def test_traced_flops_within_a_quarter_of_the_reference(ref, arch, kind):
    """The trace (matmul FLOPs plus one per pointwise output) against
    XLA's ``cost_analysis()`` of the unrolled reference."""
    ratio = _trace(arch, kind, "1")["flops"] / ref["flops"][f"{arch}|{kind}"]
    print(f"{arch} {kind}: port / reference FLOPs {ratio:.4f}")
    assert 0.75 <= ratio <= 1.25


@pytest.mark.parametrize("arch", list_archs())
def test_cache_pspec_equals_the_reference(ref, arch):
    """Every decode-cache leaf of ``decode_32k`` and ``long_500k`` on the
    single- and multi-pod production meshes; where the reference raises
    (mamba2-130m's "pod" rule on the single pod), the port raises too."""
    cfg = get_config(arch)
    model = build_model(cfg, "cpu")
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        rules = shd.make_rules(mesh, dict(cfg.sharding_overrides or ()))
        for name in DECODE_SHAPES:
            sh = SHAPES[name]
            _, spec = model.input_specs("decode", sh["seq_len"],
                                        sh["global_batch"])
            cache = dr._specs_to_meta(spec)
            want = ref["pspec"]["|".join((arch, str(multi), name))]
            got = {}
            try:
                _map_with_path(lambda p, leaf: got.__setitem__(
                    "/".join(map(str, p)),
                    [list(e) if isinstance(e, tuple) else e
                     for e in dr._cache_pspec(p, leaf, mesh, rules,
                                              sh["global_batch"])]), cache)
            except KeyError as e:
                got = "KeyError " + str(e)
            assert got == want, (multi, name)
            if isinstance(want, dict):
                shards = dr.cache_shardings(cache, mesh, rules,
                                            sh["global_batch"])
                assert all(isinstance(s, shd.NamedSharding)
                           for s in shd.tree_leaves(shards))


def test_stand_in_mesh_needs_only_names_and_sizes():
    """``_cache_pspec`` reads a mesh's ``shape`` only, as the reference's
    does, so the subprocess's stand-in for a production mesh is fair."""
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    leaf = torch.empty((2, 128, 32768, 8, 64), device="meta")
    rules = {"batch": "data", "model": "model"}
    assert dr._cache_pspec(("k",), leaf, mesh, rules, 128) == \
        shd.PartitionSpec(None, "data", "model", None, None)


def test_sweep_cell_renders_in_the_report(tmp_path):
    """One real ``sweep.run_cell`` subprocess (a full-size decode cell on
    the folded 256-device mesh) writes the reference's record schema and
    ``report`` renders it."""
    ok, secs, log = sweep.run_cell("qwen2-0.5b", "decode_32k", "single",
                                   out=str(tmp_path))
    assert ok, log
    path = sweep.cell_path(str(tmp_path), "qwen2-0.5b", "decode_32k",
                           "single")
    with open(path) as f:
        rec = json.load(f)
    assert list(rec) == ["arch", "shape", "mesh", "mode", "kind", "seq_len",
                         "global_batch", "n_devices", "params",
                         "active_params", "memory", "roofline", "timings",
                         "overrides", "counted"]
    assert list(rec["memory"]) == ["argument", "output", "temp", "alias",
                                   "per_device_bytes", "hbm_frac", "fits"]
    assert rec["counted"] == dr.COUNTED and rec["n_devices"] == 256
    assert rec["memory"]["alias"] > 0 and rec["memory"]["fits"]
    cells = report.load(str(tmp_path))
    table = report.roofline_table(cells, "single")
    assert "| qwen2-0.5b | decode_32k | ✓" in table
    assert "1 traced cells" in report.summary(cells)
