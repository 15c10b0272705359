"""Port parity: memristor fault injection (``repro_torch.runtime.faults``,
``repro_torch.sim.faults`` and the faulted ``VirtualChip``) against the
reference (``repro.runtime.faults``, ``repro.sim.faults``).

The port draws its masks from a ``torch.Generator``, the reference from
``jax.random``; the parity tests hand the reference's masks and per-core
scales to the port through `RefFaults`, a subclass overriding
``masks``/``core_scales``.  The port's own masks are held to the
reference's contract (deterministic, seed- and salt-sensitive, stuck-off
wins, per-core variation).  Tolerances: on the same masks the port's
overlay equals the reference's exactly (``where(off, 0, where(on, w_max,
g))`` after the clipped per-core scale); stuck cells read exactly 0 or
``w_max`` after every training step; ``reapply`` is idempotent under
variation; a faulted port chip against a faulted reference chip (both
eager): outputs and step errors within 1e-6, conductances within 1e-6
except where the plain unrounded pulse count lies within 1e-4 of a
half-integer (one pulse, u/2 = 1.95e-4).  Cases: kdd_anomaly (41-15-41)
and the 20-10-5 network on a 16x8 grid (several tiles and a Fig.-14
aggregation stage).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.sim import VirtualChip as JaxChip  # noqa: E402
from repro.sim import faults as jsimfaults  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.runtime.faults import MemristorFaults  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402
from repro_torch.sim.faults import inject_faults, reapply  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128

CASES = {
    "kdd_anomaly": dict(dims=[41, 15, 41], seed=0, n=4, grid={}),
    "small_grid": dict(dims=[20, 10, 5], seed=3, n=4,
                       grid=dict(rows=16, cols=8)),
}


class RefFaults(MemristorFaults):
    """The port's fault model on the reference's ``jax.random`` masks and
    per-core scales."""

    def _ref(self):
        return jfaults.MemristorFaults(self.stuck_on, self.stuck_off,
                                       self.variation_sigma, self.seed)

    def masks(self, shape, salt=0):
        on, off = self._ref().masks(tuple(shape), salt)
        return (torch.from_numpy(np.array(on)),
                torch.from_numpy(np.array(off)))

    def core_scales(self, n_cores, salt=0):
        return torch.from_numpy(np.array(
            self._ref().core_scales(n_cores, salt), dtype=np.float32))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, shape).astype(np.float32)


def _np_layers(dims, seed):
    key = jax.random.PRNGKey(seed)
    jl = [jxb.init_conductances(jax.random.fold_in(key, i), f, o,
                                japps.PAPER_SPEC)
          for i, (f, o) in enumerate(zip(dims, dims[1:]))]
    return jl, [{k: np.asarray(v) for k, v in p.items()} for p in jl]


def _port_chip(np_layers, **kw):
    return VirtualChip(interop.layers_from_numpy(np_layers, "cpu"),
                       tapps.PAPER_SPEC, device="cpu", **kw)


def plain_counts(layers, x, target, spec, lr):
    """The paper rule's unrounded pulse counts per layer (float64)."""
    acts, dps, h = [], [], torch.from_numpy(x)
    for li, p in enumerate(layers):
        if li > 0 and spec.transport_quant:
            h = tq.adc_quantize(h, spec.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = torch.from_numpy(target) - h
    unit = spec.max_update / spec.update_levels
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        delta = tq.error_quantize(delta, spec.err_bits).dequantize()
        local = delta * txb.hard_sigmoid_deriv(dps[li])
        acc = acts[li].double().T @ local.double()
        counts[li] = (2.0 * lr * acc / x.shape[0] / unit).numpy()
        delta = local @ (layers[li]["g_plus"] - layers[li]["g_minus"]).T
    return counts


def assert_layers_match(got, want, counts):
    for li, (a, b) in enumerate(zip(got, want)):
        c = counts[li]
        near = np.abs(c - np.floor(c) - 0.5) < PULSE_BOUNDARY
        for k in ("g_plus", "g_minus"):
            d = np.abs(_np(a[k]) - _np(b[k]))
            assert np.all(d[~near] <= G_ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= HALF_U + G_ATOL), (li, k)


def _stuck_cells_exact(placement, faults, w_max=1.0):
    """Every stuck cell of every stage reads exactly 0 (off) or w_max."""
    for st in placement.stages:
        for g, salt in ((st.g_plus, 2 * st.index),
                        (st.g_minus, 2 * st.index + 1)):
            on, off = faults.masks(tuple(g.shape), salt)
            assert bool((g[off] == 0.0).all())
            assert bool((g[on] == w_max).all())


# ---------------------------------------------------------------------------
# The fault model itself (tests/test_chip_sim.py, device-fault injection)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [MemristorFaults, RefFaults])
def test_fault_masks_deterministic_and_seed_sensitive(cls):
    """The port's own masks and the reference's through `RefFaults`: the
    same (seed, salt, shape) gives the same masks, another salt or seed
    others, and stuck-off wins an overlap."""
    f = cls(stuck_on=0.1, stuck_off=0.1, seed=3)
    on1, off1 = f.masks((40, 20), salt=1)
    on2, off2 = f.masks((40, 20), salt=1)
    assert on1.dtype == torch.bool and on1.device.type == "cpu"
    assert torch.equal(on1, on2) and torch.equal(off1, off2)
    on3, _ = f.masks((40, 20), salt=2)
    assert not torch.equal(on1, on3)
    on4, _ = cls(stuck_on=0.1, stuck_off=0.1, seed=4).masks((40, 20), 1)
    assert not torch.equal(on1, on4)
    assert not bool((on1 & off1).any())                    # off wins
    # the rates are what was asked for (800 cells: within 5 sigma)
    assert abs(float(off1.float().mean()) - 0.1) < 5 * (0.09 / 800) ** 0.5
    assert 0.0 < float(on1.float().mean()) < 0.2


def test_port_masks_are_a_function_of_seed_salt_and_shape():
    """Drawn on the CPU from (seed, salt) alone: the overlay is the same
    whatever dtype, device or values ``g`` holds, and the stuck-on and
    stuck-off streams do not depend on each other's rates."""
    f = MemristorFaults(stuck_on=0.05, stuck_off=0.2, seed=9)
    g = torch.rand((3, 16, 8), generator=torch.Generator().manual_seed(0))
    a = f.apply(g, salt=5)
    b = f.apply(g.double(), salt=5).float()
    on, off = f.masks((3, 16, 8), salt=5)
    assert a.device == g.device and torch.equal(a, b)
    assert bool((a[off] == 0).all()) and bool((a[on] == 1.0).all())
    assert torch.equal(a[~(on | off)], g[~(on | off)])
    # a different stuck-on rate moves no stuck-off cell
    _, off2 = MemristorFaults(stuck_on=0.3, stuck_off=0.2,
                              seed=9).masks((3, 16, 8), salt=5)
    assert torch.equal(off, off2)
    scales = f.core_scales(6)
    assert torch.equal(scales, torch.ones(6))
    s1 = MemristorFaults(variation_sigma=0.2, seed=9).core_scales(6, 5)
    s2 = MemristorFaults(variation_sigma=0.2, seed=9).core_scales(6, 5)
    assert torch.equal(s1, s2) and s1.dtype == torch.float32
    assert not torch.equal(
        s1, MemristorFaults(variation_sigma=0.2, seed=9).core_scales(6, 6))


@pytest.mark.parametrize("shape,variation", [((40, 20), True),
                                             ((5, 16, 8), True),
                                             ((5, 16, 8), False)])
def test_overlay_equals_reference_apply(shape, variation):
    """On the reference's masks and scales the port's overlay is the
    reference's, exactly."""
    g = np.random.default_rng(1).uniform(0, 1.0, shape).astype(np.float32)
    kw = dict(stuck_on=0.1, stuck_off=0.15, variation_sigma=0.3, seed=6)
    want = jfaults.MemristorFaults(**kw).apply(g, salt=3, w_max=1.0,
                                               variation=variation)
    got = RefFaults(**kw).apply(torch.from_numpy(g), salt=3, w_max=1.0,
                                variation=variation)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_fault_injection_perturbs_output_deterministically():
    dims = CASES["kdd_anomaly"]["dims"]
    jl, np_layers = _np_layers(dims, 0)
    x = _uniform(9, (4, 41))
    clean = txb.mlp_forward(interop.layers_from_numpy(np_layers, "cpu"), x,
                            tapps.PAPER_SPEC, device="cpu")
    f = RefFaults(stuck_off=0.2, seed=11)
    outs = []
    for _ in range(2):
        chip = _port_chip(np_layers)
        chip.placement = inject_faults(chip.placement, f)
        outs.append(_np(chip.infer(x)))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - _np(clean)).max() > 1e-4
    # the reference's injection on the same masks: the same stacks, and
    # the same outputs
    jchip = JaxChip(jl, japps.PAPER_SPEC)
    jchip.placement = jsimfaults.inject_faults(
        jchip.placement, jfaults.MemristorFaults(stuck_off=0.2, seed=11))
    for a, b in zip(chip.placement.stages, jchip.placement.stages):
        np.testing.assert_array_equal(_np(a.g_plus), np.asarray(b.g_plus))
        np.testing.assert_array_equal(_np(a.g_minus), np.asarray(b.g_minus))
    np.testing.assert_allclose(outs[0], np.asarray(jchip.infer(x)),
                               atol=G_ATOL)


def test_null_faults_are_identity():
    chip = _port_chip(_np_layers([41, 15, 41], 0)[1])
    pl, version = chip.placement, chip.placement.version
    assert inject_faults(pl, MemristorFaults()) is pl
    assert reapply(pl, MemristorFaults()) is pl and pl.version == version


@pytest.mark.parametrize("cls", [MemristorFaults, RefFaults])
def test_chip_owned_faults_stay_stuck_through_training(cls):
    """A chip built with faults re-asserts the stuck masks after every
    train_step itself, in place — pulse updates cannot heal a broken
    device — and runs the eager path although compiled is the default."""
    dims = [41, 15, 41]
    f = cls(stuck_on=0.05, stuck_off=0.3, seed=2)
    chip = _port_chip(_np_layers(dims, 0)[1], faults=f)
    assert chip.compiled and not chip._compiled_active()
    x = _uniform(9, (4, 41))
    for _ in range(2):
        tensors = [st.g_plus for st in chip.placement.stages]
        chip.train_step(x, x, lr=0.5)
        _stuck_cells_exact(chip.placement, f)
        # the update replaced the stacks; the re-assert wrote into them
        assert all(st.g_plus is not t for st, t in
                   zip(chip.placement.stages, tensors))
    assert chip._stacks is None


def test_reapply_is_idempotent_under_variation():
    """Fabrication variation scales conductances once at injection;
    re-asserting the stuck masks must not compound it."""
    chip = _port_chip(_np_layers([41, 15, 41], 0)[1])
    f = MemristorFaults(stuck_off=0.1, variation_sigma=0.3, seed=5)
    p1 = inject_faults(chip.placement, f)
    assert p1 is not chip.placement
    before = [(st.g_plus.clone(), st.g_minus.clone()) for st in p1.stages]
    views = [st.g_plus for st in p1.stages]
    p2 = reapply(reapply(p1, f), f)
    assert p2 is p1 and p1.version == 2
    for (gp, gm), st, view in zip(before, p1.stages, views):
        assert torch.equal(gp, st.g_plus) and torch.equal(gm, st.g_minus)
        assert st.g_plus is view                     # written in place
    # variation cannot push conductance past the physical maximum
    assert all(float(st.g_plus.max()) <= 1.0 for st in p1.stages)


def test_reapply_writes_through_envelope_views():
    """A compiled chip's stages are views of its envelope: re-asserting
    the masks in place reaches the envelope itself."""
    chip = _port_chip(_np_layers([41, 15, 41], 0)[1])
    x = _uniform(9, (4, 41))
    chip.train_step(x, x, lr=0.1)
    stacks = chip._get_stacks()
    f = MemristorFaults(stuck_on=0.2, stuck_off=0.2, seed=1)
    reapply(chip.placement, f)
    for s, st in enumerate(chip.placement.stages):
        T = st.row_tiles * st.col_tiles
        assert torch.equal(stacks.g_plus[s, :T], st.g_plus)
    _stuck_cells_exact(chip.placement, f)


@pytest.mark.parametrize("cls", [MemristorFaults, RefFaults])
def test_variation_scales_per_core(cls):
    f = cls(variation_sigma=0.2, seed=4)
    out = _np(f.apply(torch.ones((5, 8, 4))))
    per_core = out.reshape(5, -1)
    # within a core the scale is uniform; across cores it varies
    assert np.allclose(per_core.std(axis=1), 0.0, atol=1e-6)
    assert per_core.mean(axis=1).std() > 1e-3


# ---------------------------------------------------------------------------
# A faulted port chip against a faulted reference chip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_faulted_chip_matches_reference(name):
    """Both chips eager (a chip that owns faults runs the eager path on
    both sides): the injected stacks equal, one recognition wave and two
    training steps, the stuck cells exact after each."""
    c = CASES[name]
    jl, np_layers = _np_layers(c["dims"], c["seed"])
    kw = dict(stuck_on=0.05, stuck_off=0.1, variation_sigma=0.2, seed=7)
    jchip = JaxChip(jl, japps.PAPER_SPEC, name=name,
                    faults=jfaults.MemristorFaults(**kw), **c["grid"])
    f = RefFaults(**kw)
    tchip = _port_chip(np_layers, name=name, faults=f, **c["grid"])
    for a, b in zip(tchip.placement.stages, jchip.placement.stages):
        np.testing.assert_array_equal(_np(a.g_plus), np.asarray(b.g_plus))
        np.testing.assert_array_equal(_np(a.g_minus), np.asarray(b.g_minus))
    spec = dataclasses.replace(tapps.PAPER_SPEC, **c["grid"])
    x = _uniform(20, (c["n"], c["dims"][0]))
    np.testing.assert_allclose(_np(tchip.infer(x)),
                               np.asarray(jchip.infer(x)), atol=G_ATOL)
    for step in range(2):
        xs = _uniform(30 + step, (c["n"], c["dims"][0]))
        tgt = _uniform(40 + step, (c["n"], c["dims"][-1]))
        counts = plain_counts(tchip.layers(), xs, tgt, spec, 0.3)
        jerr = jchip.train_step(xs, tgt, lr=0.3)
        terr = tchip.train_step(xs, tgt, lr=0.3)
        np.testing.assert_allclose(_np(terr), np.asarray(jerr), atol=G_ATOL)
        assert_layers_match(tchip.layers(), jchip.layers(), counts)
        _stuck_cells_exact(tchip.placement, f)
    assert tchip.train_counters.slots == jchip.train_counters.slots
    assert tchip.train_counters.core_steps == jchip.train_counters.core_steps


def test_cli_runs_with_stuck_devices(tmp_path, capsys):
    from repro_torch.launch import chipsim
    out = tmp_path / "faulted.json"
    chipsim.main(["--stuck-off", "0.05", "--device", "cpu", "--samples",
                  "4", "--train-steps", "2", "--json", str(out)])
    text = capsys.readouterr().out
    assert "faults: stuck_on=0.0 stuck_off=0.05 variation_sigma=0.0" in text
    assert "train step 1" in text and "cross-validation vs hw_model" in text
    assert out.exists()
    # the CLI's chip is the faulted one: build_chip(faults=) injects
    f = MemristorFaults(stuck_off=0.05)
    chip = chipsim.build_chip("kdd_anomaly", device="cpu", faults=f)
    clean = chipsim.build_chip("kdd_anomaly", device="cpu")
    assert chip.faults is f and not chip._compiled_active()
    _stuck_cells_exact(chip.placement, f)
    assert not torch.equal(chip.placement.stages[0].g_plus,
                           clean.placement.stages[0].g_plus)


def test_fault_sweep_example_accuracy_falls_with_stuck_fraction(capsys):
    """``examples/torch_fault_sweep.py`` on the CPU: a clean chip
    classifies the mixture, and the mean accuracy over the fabricated
    chips never rises with the stuck fraction and ends below it."""
    path = REPO / "examples" / "torch_fault_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_fault_sweep", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    means = example.memristor_fault_sweep("cpu", 0)
    accs = [means[r] for r in example.RATES]
    assert accs[0] == 1.0
    assert all(a >= b for a, b in zip(accs, accs[1:]))
    assert accs[-1] < accs[0]
    assert capsys.readouterr().out.count("stuck fraction") == 5
