"""Port parity: ``repro_torch.dist`` (the mesh rules, the compressed
gradient mean, the data-parallel step, the GPipe pipeline),
``repro_torch.launch.mesh`` and the meshed ``Trainer`` and restore,
against ``repro.dist``, ``repro.launch.mesh`` and ``repro.runtime``.

The reference's multi-device cases run once, in one module-scoped
8-device subprocess (``tests/conftest.py``, ``run_subprocess``) that
writes an ``.npz``: the compressed mean of distinct per-device gradients
(``in_specs=P("data")`` on a stacked axis) in all three modes with the
int8 leg's noise, two ``dp_train_step_fn`` steps on the reduced
qwen2-0.5b in modes "none" and "bf16" with each step's state, and the
tanh toy through ``pipeline_apply`` on 4 devices.  The rules run
in-process on ``jax.sharding.AbstractMesh``, which needs no devices.

Tolerances, each with its reason:
- the rules and specs: equal (the same decisions on the same shapes).
- ``compressed_grad_mean``: bit for bit in every mode.  XLA's CPU
  all-reduce adds the devices in ascending order in float32 ("none"), and
  a bf16 all-reduce as the float32 sum in that order of the bf16 values,
  rounded once to bf16, divided by 8 in bf16; the port sums so.  The int8
  leg is compared as integer codes on the reference's noise.
- ``dp_train_step_fn``: each step from the reference's state before it,
  within ``test_train_step_matches_reference``'s bars
  (``tests/test_torch_train_step.py``): the loss within 1e-5 relative,
  the moments within 1e-4 of each leaf's largest, the parameters within
  1e-6 (2 lr where |g| is below 1e-3 of the leaf's largest).  In "bf16"
  a per-device gradient that lies next to a bf16 rounding boundary may
  round to the neighbouring bf16 value on one side: a step that misses
  the bars is excused only where such inputs were seen (within 1e-4
  relative of a boundary, counted), and is then held with the loss
  within 1e-3 relative, the moments within 10 % in the Frobenius norm and
  every parameter within 2 lr (the bars' quantizer excuse).
- ``pipeline_apply``: within 1e-5 of the reference's, as
  ``test_pipeline_matches_serial`` holds it; bit for bit against the
  port's ``serial_reference`` with a stage that runs microbatch by
  microbatch (the same operations on the same shapes).
- the meshed ``Trainer`` and a restore onto shardings: bit for bit
  against the unmeshed ones (the same operations on one device).
"""
import numpy as np
import pytest
import jax
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_reduced_config as jreduced  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import train_loop as jtrain  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import pipeline as pipe  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import block_apply  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Trainer, checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402

ARCH = "qwen2-0.5b"
LR = 1e-3
NEAR = 1e-4         # a per-device gradient this close to a bf16 boundary
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]

REFERENCE = r'''
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs import get_reduced_config
from repro.data.pipeline import TokenStream
from repro.dist.collectives import compressed_grad_mean, dp_train_step_fn
from repro.dist.pipeline import pipeline_apply, serial_reference
from repro.models import build_model
from repro.optim import adamw

out = {}


def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(v)


auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((8,), ("data",), axis_types=(auto,))
rng = np.random.default_rng(0)
g = {"w": (rng.standard_normal((8, 40, 33))
           * np.exp(rng.standard_normal((8, 40, 33)))).astype(np.float32),
     "b": rng.standard_normal((8, 5)).astype(np.float32)}
flat("grads", g)
key = jax.random.PRNGKey(3)
for mode in ("none", "bf16", "int8"):
    fn = jax.jit(jax.shard_map(
        lambda gs: compressed_grad_mean(jax.tree.map(lambda a: a[0], gs),
                                        mesh, ("data",), mode=mode, key=key),
        mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False))
    flat(f"mean_{mode}", fn(jax.tree.map(jnp.asarray, g)))
# the int8 leg's noise: one fold_in per leaf, in the reference's leaf order
for i, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(g)[0]):
    out[f"noise/{path[0].key}"] = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), leaf.shape[1:], jnp.float32))

cfg = get_reduced_config("qwen2-0.5b", compute_dtype="float32")
model = build_model(cfg)
params0 = model.init(jax.random.PRNGKey(0))
flat("params0", params0)
ts = TokenStream(cfg.vocab_size, 32, 16, seed=0)
for s in range(2):
    flat(f"batch{s}", ts.batch_at(s))
for mode in ("none", "bf16"):
    opt = adamw(LR)
    params = jax.tree.map(jnp.copy, params0)
    opt_state = opt.init(params)
    step_fn = dp_train_step_fn(model.loss_fn, opt, mesh, compression=mode)
    for s in range(2):
        params, opt_state, loss = step_fn(params, opt_state, ts.batch_at(s),
                                          jnp.int32(s), jax.random.PRNGKey(s))
        out[f"dp_{mode}/loss{s}"] = np.asarray(loss)
        flat(f"dp_{mode}/params{s}", params)
        flat(f"dp_{mode}/opt{s}", opt_state)

pmesh = jax.make_mesh((4,), ("pipe",), devices=jax.devices()[:4],
                      axis_types=(auto,))
n_stages, n_micro, mb, d = 4, 6, 3, 8
pkey = jax.random.PRNGKey(0)
pp = {"w": jax.random.normal(pkey, (n_stages, d, d)) * 0.3,
      "b": jax.random.normal(pkey, (n_stages, d)) * 0.1}


def stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


x = jax.random.normal(jax.random.PRNGKey(1), (n_micro, mb, d))
flat("pipe_params", pp)
out["pipe_x"] = np.asarray(x)
out["pipe_out"] = np.asarray(jax.jit(
    lambda p, x: pipeline_apply(stage, p, x, mesh=pmesh,
                                axis_name="pipe"))(pp, x))
np.savez(sys.argv[1], **out)
print("OK", len(out))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory, subproc):
    path = tmp_path_factory.mktemp("ref_dist") / "ref.npz"
    code = REFERENCE.replace("adamw(LR)", f"adamw({LR})")
    out = subproc(f"import sys; sys.argv = ['ref', {str(path)!r}]\n" + code,
                  devices=8)
    assert "OK" in out, out
    with np.load(path) as data:
        return dict(data)


def _sub(ref, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


def _port_tree(like, flat):
    """``like``'s structure holding ``flat``'s arrays, keyed by path."""
    return ckpt._rebuild(like, lambda path, _: torch.from_numpy(
        np.array(flat[ckpt._key(path)])))


def _flat_port(tree):
    return {ckpt._key(p): t for p, t in ckpt._walk(tree)}


def _ref_spec_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


# ---------------------------------------------------------------------------
# the rules (in-process; AbstractMesh needs no devices)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", MESHES)
def test_rules_and_specs_match_reference(shape, axes):
    amesh = AbstractMesh(shape, axes)
    mesh = shd.Mesh(shape, axes, "cpu")
    assert shd.make_rules(mesh) == jshd.make_rules(amesh)
    n = 0
    for arch in list_archs():
        for tcfg, jcfg in ((get_config(arch), jget(arch)),
                           (get_reduced_config(arch), jreduced(arch))):
            overrides = dict(tcfg.sharding_overrides or ())
            assert overrides == dict(jcfg.sharding_overrides or ())
            rules = shd.make_rules(mesh, overrides)
            assert rules == jshd.make_rules(amesh, overrides)
            got = {k: tuple(v) for k, v in _flat_port(shd.partition_specs(
                build_model(tcfg, "meta").spec, rules, mesh)).items()}
            want = _ref_spec_flat(jshd.partition_specs(
                jbuild(jcfg).spec, rules, amesh))
            assert got == want, (arch, tcfg.name)
            n += len(got)
    assert n > 200


def test_pspec_divisibility_fallback():
    """The cases of ``tests/test_distribution.py``'s fallback test, port
    and reference side by side."""
    P = shd.PartitionSpec
    for shape, axes, cases in (
            ((2, 4), ("data", "model"),
             [(("fsdp", "heads"), (8, 16), P("data", "model")),
              (("fsdp", "heads"), (7, 16), P(None, "model")),
              (("fsdp", "heads"), (8, 14), P("data"))]),
            ((2, 2, 2), ("pod", "data", "model"),
             [(("batch", None), (4, 3), P(("pod", "data"))),
              (("batch", None), (2, 3), P("pod"))])):
        mesh, amesh = shd.Mesh(shape, axes, "cpu"), AbstractMesh(shape, axes)
        rules = shd.make_rules(mesh)
        for logical, dims, want in cases:
            got = shd.logical_to_pspec(logical, rules, mesh, dims)
            assert got == want and tuple(got) == tuple(
                jshd.logical_to_pspec(logical, rules, amesh, dims))
    # the spec is a tree leaf that compares as its tuple
    assert P("data", None) == ("data", None) and P("a") != P("b")
    assert shd.tree_leaves({"x": P("data", "model")}) == [P("data",
                                                             "model")]


def test_meshes_fold_onto_one_device():
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    host = make_host_mesh(device="cpu")
    given = make_host_mesh((4, 2), device="cpu")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert host.shape == {"data": 1, "model": 1}
    assert given.axis_sizes == (4, 2) and given.device.type == "cpu"
    if not torch.cuda.is_available():
        for make in (make_production_mesh, make_host_mesh):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    with pytest.raises(ValueError):
        shd.Mesh((2,), ("data", "model"), "cpu")


def test_activation_constraints_are_identities_on_one_device():
    x = torch.randn(2, 3, 4)
    assert shd.shard_activation(x, "batch", "seq") is x
    mesh = make_host_mesh((2, 2), device="cpu")
    spec = {"w": shd.ParamSpec((3, 4), ("fsdp", "heads"),
                               shd.zeros_init())}
    params = {"w": torch.ones(3, 4)}
    with shd.activation_sharding(mesh, shd.make_rules(mesh)):
        with shd.activation_sharding(mesh, {}):
            assert shd._current_ctx()[1] == {}
        assert shd._current_ctx()[0] is mesh
        assert shd.shard_activation(x, "batch", "seq", "act_embed") is x
        assert shd.constrain_like_specs(params, spec)["w"] is params["w"]
    assert shd._current_ctx() is None
    assert shd.constrain_like_specs(params, spec) is params


# ---------------------------------------------------------------------------
# compressed_grad_mean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compressed_grad_mean_matches_reference(ref, mode):
    mesh = shd.Mesh((8,), ("data",), "cpu")
    grads = {k: torch.from_numpy(v) for k, v in _sub(ref, "grads").items()}
    noise = {k: torch.from_numpy(v) for k, v in _sub(ref, "noise").items()}
    got = coll.compressed_grad_mean(
        grads, mesh, ("data",), mode=mode,
        noise=noise if mode == "int8" else None)
    want = _sub(ref, f"mean_{mode}")
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        if mode != "int8":
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            continue
        m = coll.compressed_grad_mean({k: grads[k]}, mesh, ("data",),
                                      mode="bf16")[k]
        scale = m.abs().max() / coll.INT8_MAX
        codes = torch.round(got[k] / scale)
        assert torch.equal(codes, torch.round(torch.from_numpy(w) / scale))
        assert codes.abs().max() <= coll.INT8_MAX
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    with pytest.raises(ValueError, match="leading axis"):
        coll.compressed_grad_mean({"w": torch.zeros(7, 3)}, mesh, ("data",))
    with pytest.raises(ValueError, match="generator"):
        coll.compressed_grad_mean(grads, mesh, ("data",), mode="int8")


def test_int8_compression_unbiased():
    """Stochastic rounding makes the int8 broadcast leg unbiased: averaging
    over many generators converges to the exact mean (the reference's
    ``test_int8_compression_unbiased`` on the port)."""
    mesh = shd.Mesh((8,), ("data",), "cpu")
    w = torch.linspace(-0.917, 0.731, 256)
    g = {"w": w.expand(8, 256).clone()}

    def run(seed):
        return coll.compressed_grad_mean(
            g, mesh, ("data",), mode="int8",
            generator=torch.Generator().manual_seed(seed))["w"]

    avg = torch.stack([run(s) for s in range(48)]).mean(0)
    err_one = float((run(0) - w).abs().max())
    bias = float((avg - w).abs().max())
    assert bias < err_one / 2, (bias, err_one)
    assert bias < 4e-3, bias
    assert torch.equal(run(5), run(5))


# ---------------------------------------------------------------------------
# dp_train_step_fn
# ---------------------------------------------------------------------------

def _near_bf16_boundary(stacked: torch.Tensor) -> torch.Tensor:
    """Elements where some device's float32 value lies within NEAR
    (relative) of a bf16 rounding boundary."""
    a = stacked.double().abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.where(a > 0, a, torch.ones_like(a)))) - 7)
    frac = a / ulp - torch.floor(a / ulp)
    return (((frac - 0.5).abs() * ulp <= NEAR * a) & (a > 0)).any(0)


@pytest.mark.parametrize("mode", ["none", "bf16"])
def test_dp_train_step_matches_reference(ref, mode, monkeypatch):
    cfg = get_reduced_config(ARCH, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    like = model.abstract_params()
    mesh = shd.Mesh((8,), ("data",), "cpu")
    seen = []
    mean = coll.compressed_grad_mean

    def spy(grads, *a, **kw):
        seen.append(grads)
        return mean(grads, *a, **kw)

    monkeypatch.setattr(coll, "compressed_grad_mean", spy)
    opt = adamw(LR)
    step_fn = coll.dp_train_step_fn(model.loss_fn, opt, mesh,
                                    compression=mode)
    for s in range(2):
        if s == 0:
            params = _port_tree(like, _sub(ref, "params0"))
            state = opt.init(params)
            prev = None
        else:
            params = _port_tree(like, _sub(ref, f"dp_{mode}/params{s - 1}"))
            prev = _sub(ref, f"dp_{mode}/opt{s - 1}")
            state = {m: _port_tree(like, _sub(prev, m)) for m in ("m", "v")}
        batch = {k: torch.from_numpy(v)
                 for k, v in _sub(ref, f"batch{s}").items()}
        seen.clear()
        params, state, loss = step_fn(params, state, batch, s)
        assert len(seen) == 1
        near = {k: _near_bf16_boundary(g).numpy() if mode == "bf16"
                else np.zeros(g.shape[1:], bool)
                for k, g in _flat_port(seen[0]).items()}
        want_p = _sub(ref, f"dp_{mode}/params{s}")
        want_o = _sub(ref, f"dp_{mode}/opt{s}")
        want_loss = float(ref[f"dp_{mode}/loss{s}"])

        def check(strict: bool) -> int:
            rtol = 1e-5 if strict else 1e-3
            assert abs(float(loss) - want_loss) <= rtol * abs(want_loss)
            excused = 0
            for k, t in _flat_port(params).items():
                g = (want_o[f"m/{k}"] - (0.9 * prev[f"m/{k}"] if prev
                                         else 0.0)) / 0.1
                small = (np.abs(g) <= 1e-3 * np.abs(g).max() if strict
                         else np.ones(g.shape, bool))
                err = np.abs(t.numpy() - want_p[k])
                assert (err[~small] <= 1e-6).all(), (k, err[~small].max())
                assert (err[small] <= 2 * LR + 1e-6).all(), k
                excused += int((err[small] > 1e-6).sum())
            for m in ("m", "v"):
                for k, t in _flat_port(state[m]).items():
                    w = want_o[f"{m}/{k}"]
                    if strict:
                        err = np.abs(t.numpy() - w).max()
                        assert err <= 1e-4 * np.abs(w).max(), (m, k)
                    else:
                        assert (np.linalg.norm(t.numpy() - w)
                                <= 0.1 * np.linalg.norm(w)), (m, k)
            return excused

        n_near = sum(int(v.sum()) for v in near.values())
        try:
            excused = check(strict=True)
        except AssertionError:
            print(f"dp step {s} ({mode}): off the fp32 bars with {n_near} "
                  f"gradients within {NEAR} of a bf16 rounding boundary")
            assert mode == "bf16" and n_near > 0
            excused = check(strict=False)
        print(f"dp step {s} ({mode}): {excused} parameters moved by more "
              f"than 1e-6 apart, {n_near} near-boundary gradients")


def test_dp_train_step_with_int8_compression_decreases_loss():
    """The reference's ``test_dp_train_step_with_compression_decreases_
    loss`` on the port: 8 int8 steps on an 8-device mesh folded onto the
    CPU."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh((8,), ("data",), device="cpu")
    opt = adamw(3e-3)
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt.init(params)
    step_fn = coll.dp_train_step_fn(model.loss_fn, opt, mesh,
                                    compression="int8")
    ts = TokenStream(cfg.vocab_size, 32, 16, seed=0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for s in range(8):
        params, opt_state, loss = step_fn(params, opt_state, ts.batch_at(s),
                                          s, gen)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_dp_step_on_one_device_is_the_train_step():
    """One shard: the mean of one gradient is that gradient, so the step
    equals ``make_train_step``'s bit for bit, params and state."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, "cpu")
    ts = TokenStream(cfg.vocab_size, 32, 4, seed=1)
    runs = []
    for dp in (False, True):
        opt = adamw(3e-3)
        params = model.init(torch.Generator().manual_seed(0))
        state = opt.init(params)
        step = (coll.dp_train_step_fn(model.loss_fn, opt,
                                      make_host_mesh(device="cpu"),
                                      compression="none") if dp
                else make_train_step(model, opt))
        for s in range(2):
            params, state, out = step(params, state, ts.batch_at(s), s)
        runs.append((params, state, out if dp else out["loss"]))
    (p0, s0, l0), (p1, s1, l1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(shd.tree_leaves((p0, s0)), shd.tree_leaves((p1, s1))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split"):
        coll.shard_rows(torch.zeros(6, 2), 0, 4)


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------

def _tanh_stage(p, x):
    """The reference test's stage, run microbatch by microbatch."""
    if x.dim() == 3:
        return torch.stack([_tanh_stage(p, xi) for xi in x])
    return torch.tanh(x @ p["w"] + p["b"])


def test_pipeline_matches_reference_and_serial(ref):
    params = {k: torch.from_numpy(v)
              for k, v in _sub(ref, "pipe_params").items()}
    x = torch.from_numpy(ref["pipe_x"])
    mesh = shd.Mesh((4,), ("pipe",), "cpu")
    got = pipe.pipeline_apply(_tanh_stage, params, x, mesh=mesh,
                              axis_name="pipe")
    np.testing.assert_allclose(got.numpy(), ref["pipe_out"], atol=1e-5)
    assert torch.equal(got, pipe.serial_reference(_tanh_stage, params, x))

    # a bubble's output (NaN on the zero feed) never reaches the result
    def nan_on_zero(p, x):
        if x.dim() == 3:
            return torch.stack([nan_on_zero(p, xi) for xi in x])
        return _tanh_stage(p, x) * x.abs().sum() / x.abs().sum()

    got = pipe.pipeline_apply(nan_on_zero, params, x, mesh=mesh,
                              axis_name="pipe")
    assert not got.isnan().any()
    assert torch.equal(got, pipe.serial_reference(nan_on_zero, params, x))
    with pytest.raises(ValueError, match="stages"):
        pipe.pipeline_apply(_tanh_stage, params, x,
                            mesh=shd.Mesh((2,), ("pipe",), "cpu"),
                            axis_name="pipe")


def test_pipeline_of_lm_layers_is_serial_bit_for_bit():
    """Four stages of the reduced qwen2-0.5b's decoder layer, bf16, over 5
    microbatches: the pipeline equals ``serial_reference``."""
    cfg = get_reduced_config(ARCH).replace(n_layers=4)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))["stack"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((5, 2, 16, cfg.d_model), generator=gen).to(
        torch.bfloat16)
    positions = torch.arange(16)[None, :].expand(2, 16)

    def stage(p, h):
        if h.dim() == 4:
            return torch.stack([stage(p, hi) for hi in h])
        p = shd.cast_for_compute(p, torch.bfloat16)
        h, _, _ = block_apply(cfg, "attn", p["b0_attn"], h,
                              positions=positions, cache=None, xbar=None,
                              compute_dtype=torch.bfloat16)
        return h

    mesh = shd.Mesh((4,), ("pipe",), "cpu")
    got = pipe.pipeline_apply(stage, params, x, mesh=mesh, axis_name="pipe")
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, pipe.serial_reference(stage, params, x))


# ---------------------------------------------------------------------------
# the meshed Trainer and restore
# ---------------------------------------------------------------------------

def _specs(tree):
    return {k: tuple(v.spec) for k, v in _flat_port(tree).items()}


def _jspecs(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(v.spec)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_meshed_trainer_shardings_match_reference():
    cfg, jcfg = get_reduced_config(ARCH), jreduced(ARCH)
    host = Trainer(cfg, adamw(3e-3), mesh=make_host_mesh(device="cpu"))
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jhost = JTrainer(jcfg, jadamw(3e-3), mesh=jmesh)
    assert host.rules == jhost.rules
    assert _specs(host.param_shardings) == _jspecs(jhost.param_shardings)
    assert _specs(host.opt_shardings) == _jspecs(jhost.opt_shardings)
    assert tuple(host.batch_sharding.spec) == tuple(jhost.batch_sharding.spec)
    assert host.device.type == "cpu"
    # the production mesh, folded: the reference's specs on AbstractMesh
    prod = Trainer(cfg, adamw(3e-3), mesh=make_production_mesh(device="cpu"))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    jps = jshd.partition_specs(jbuild(jcfg).spec, jshd.make_rules(amesh),
                               amesh)
    jsh = jax.tree.map(lambda s: JNamedSharding(amesh, s), jps,
                       is_leaf=lambda x: isinstance(x, JP))
    abs_params = jbuild(jcfg).abstract_params()
    jopt = jtrain._mirror_shardings(
        jax.eval_shape(jadamw(3e-3).init, abs_params), abs_params, jsh)
    assert _specs(prod.param_shardings) == _jspecs(jsh)
    assert _specs(prod.opt_shardings) == _jspecs(jopt)
    assert {s for s in _specs(prod.opt_shardings).values()} > {()}
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, adamw(3e-3), mesh=make_host_mesh(device="cpu"),
                device="meta")


def test_meshed_trainer_and_restore_match_unmeshed(tmp_path):
    cfg = get_reduced_config(ARCH)
    stream = TokenStream(cfg.vocab_size, 32, 4, seed=0)
    plain, _ = Trainer(cfg, adamw(3e-3), device="cpu").run(stream, 2,
                                                           log_every=100)
    meshed, hist = Trainer(cfg, adamw(3e-3),
                           mesh=make_host_mesh(device="cpu")).run(
        stream, 2, log_every=100)
    for a, b in zip(shd.tree_leaves((plain.params, plain.opt_state)),
                    shd.tree_leaves((meshed.params, meshed.opt_state))):
        assert torch.equal(a, b)
    # interrupted at step 1, restored onto the shardings, resumed to 2
    d = str(tmp_path)
    Trainer(cfg, adamw(3e-3), mesh=make_host_mesh(device="cpu"), ckpt_dir=d,
            ckpt_every=1).run(stream, 1, log_every=100)
    resumed = Trainer(cfg, adamw(3e-3), mesh=make_host_mesh(device="cpu"),
                      ckpt_dir=d, ckpt_every=1)
    state, rhist = resumed.run(stream, 2, log_every=100)
    assert [h["step"] for h in rhist] == [2] and rhist[0]["loss"] == hist[1][
        "loss"]
    for a, b in zip(shd.tree_leaves((plain.params, plain.opt_state)),
                    shd.tree_leaves((state.params, state.opt_state))):
        assert a.device.type == "cpu" and torch.equal(a, b)
