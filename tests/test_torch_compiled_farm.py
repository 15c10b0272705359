"""Port against port: the compiled farm (``repro_torch.sim.compiled``'s
chip-axis programs and serving beat) against the eager farm
(``ChipFarm(..., compiled=False)``), the statements of
``tests/test_compiled_step.py``'s farm tests; plus one program per
(program, shapes), the serving session's lane-depth bucketing and the
farm envelope, whose stage views are contiguous and updated in place.

Tolerances: the bars the port holds for the serial chip's compiled
against eager (``tests/test_torch_compiled.py``): errors and outputs
within 1e-6; conductances within 1e-6 except where the plain unrounded
pulse count lies within 1e-4 of a half-integer (one pulse, u/2 =
1.95e-4); replicas bit for bit in lockstep; counters, link bits and
serving stats exactly equal.  The compiled serving session and the eager
server compute the same function (the beat's gather-sum is the
aggregation launch's sum, and both carry the hard ADC), so their outputs
are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.runtime.serve_loop import RequestQueue  # noqa: E402
from repro_torch.sim import compiled as csim  # noqa: E402
from repro_torch.sim.cluster import FarmServer, build_farm  # noqa: E402

G_ATOL = 1e-6
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128
SPEC = tapps.PAPER_SPEC


def _x(width, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n, width)).astype(np.float32))


def _farms(app, chips, seed=0):
    return (build_farm(app, chips, seed=seed, device="cpu"),
            build_farm(app, chips, seed=seed, device="cpu", compiled=False))


def plain_counts(layers, x, target, lr):
    """The paper rule's unrounded pulse counts per layer (float64)."""
    acts, dps, h = [], [], x
    for li, p in enumerate(layers):
        if li > 0:
            h = tq.adc_quantize(h, SPEC.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = txb.hard_sigmoid(dps[-1])
    delta = target - h
    unit = SPEC.max_update / SPEC.update_levels
    counts = [None] * len(layers)
    for li in reversed(range(len(layers))):
        delta = tq.error_quantize(delta, SPEC.err_bits).dequantize()
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
            d = (a[k] - b[k]).abs().numpy()
            assert np.all(d[~near] <= G_ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= HALF_U + G_ATOL), (li, k)


def _counters(c):
    return (c.samples, dict(c.slots), dict(c.core_steps), c.io_bits,
            c.noc.slot_cycles, c.noc.routed_outputs, c.noc.max_link_cycles,
            c.noc.payload_bits, c.noc.capacity_bits)


@pytest.mark.parametrize("app,chips,n", [("kdd_anomaly", 2, 7),
                                         ("mnist_class", 3, 8)])
def test_compiled_farm_serve_matches_eager_reference(app, chips, n):
    farm_c, farm_e = _farms(app, chips)
    x = _x(farm_c.placement.dims[0], n, 5)
    out_c, stats_c = farm_c.serve(x)
    out_e, stats_e = farm_e.serve(x)
    assert torch.equal(out_c, out_e)
    assert stats_c == stats_e
    for cc, ce in zip(farm_c.chip_infer, farm_e.chip_infer):
        assert _counters(cc) == _counters(ce)
    assert farm_c.serve_full_beats == farm_e.serve_full_beats
    assert farm_c.serve_beats == farm_e.serve_beats
    assert dataclasses.astuple(farm_c.serve_link) == \
        dataclasses.astuple(farm_e.serve_link)
    ref = txb.mlp_forward(farm_c.layers(), x, SPEC, device="cpu")
    np.testing.assert_allclose(out_c.numpy(), ref.numpy(), atol=1e-5)


def test_compiled_serve_keeps_cross_session_microbatch_contract():
    """The eager server pins one request microbatch per server lifetime;
    the compiled session path enforces the same contract (a second
    session with a different microbatch falls back to the eager path,
    which raises the documented error)."""
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    server = FarmServer(farm)
    server.run(RequestQueue([torch.zeros((2, 41))] * 4))      # m=2 session
    with pytest.raises(ValueError, match="uniform request shapes"):
        server.run(RequestQueue([torch.zeros((3, 41))] * 4))  # m=3 rejected


@pytest.mark.parametrize("reconcile", ["none", "int8"])
def test_compiled_farm_train_matches_eager_reference(reconcile):
    farm_c, farm_e = _farms("kdd_anomaly", 2)
    x = _x(41, 8, 6)
    counts = plain_counts(farm_e.layers(), x, x, 0.1)
    ec = farm_c.train_step(x, x, lr=0.1, reconcile=reconcile)
    ee = farm_e.train_step(x, x, lr=0.1, reconcile=reconcile)
    np.testing.assert_allclose(ec.numpy(), ee.numpy(), atol=G_ATOL)
    assert_layers_match(farm_c.layers(), farm_e.layers(), counts)
    assert farm_c.replicas_in_sync() and farm_e.replicas_in_sync()
    for cc, ce in zip(farm_c.chip_train, farm_e.chip_train):
        assert _counters(cc) == _counters(ce)
    assert dataclasses.astuple(farm_c.train_link) == \
        dataclasses.astuple(farm_e.train_link)


def test_compiled_farm_mnist_matches_eager_over_steps():
    """mnist_class (a fan-in-split stage with its aggregation) at 2
    chips: a wave and two steps, compiled against eager."""
    farm_c, farm_e = _farms("mnist_class", 2, seed=1)
    x, t = _x(784, 4, 7), _x(10, 4, 8)
    np.testing.assert_allclose(farm_c.infer(x).numpy(),
                               farm_e.infer(x).numpy(), atol=G_ATOL)
    for _ in range(2):
        counts = plain_counts(farm_e.layers(), x, t, 0.1)
        ec = farm_c.train_step(x, t, lr=0.1)
        ee = farm_e.train_step(x, t, lr=0.1)
        np.testing.assert_allclose(ec.numpy(), ee.numpy(), atol=G_ATOL)
        assert_layers_match(farm_c.layers(), farm_e.layers(), counts)
    assert farm_c.replicas_in_sync()


def test_one_program_per_farm_program_and_shape():
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    x = _x(41, 4, 3)
    csim.reset_capture_counts()
    for _ in range(3):
        farm.train_step(x, x, lr=0.1)
        farm.infer(x)
    cfg = farm._cfg
    key_train = ("chip_train", cfg, (2, 2, 41), "none")
    key_infer = ("chip_infer", cfg, (2, 2, 41))
    assert csim.capture_counts() == {key_train: 1, key_infer: 1}
    farm.train_step(x, x, lr=0.37)          # lr_eff is a device buffer
    farm.train_step(x, x, lr=0.1, reconcile="int8")
    farm.train_step(x[:2], x[:2], lr=0.1)
    counts = csim.capture_counts()
    assert counts[key_train] == 1 and len(counts) == 4
    assert counts[("chip_train", cfg, (2, 2, 41), "int8")] == 1
    assert counts[("chip_train", cfg, (2, 1, 41), "none")] == 1


def test_serve_lane_depth_bucketing():
    """The queue's lane depth is bucketed to a power of two: queues of 5
    and 7 requests on 2 lanes (depths 3 and 4) share one program, 9
    (depth 5) builds the next; the stats keep the real schedule."""
    farm = build_farm("kdd_anomaly", 2, seed=0, device="cpu")
    csim.reset_capture_counts()
    S = len(farm.placement.stages)
    for n, depth in ((5, 3), (7, 4), (9, 5)):
        x = _x(41, n, n)
        out, stats = farm.serve(x)
        assert stats["beats"] == S - 1 + depth
        ref = txb.mlp_forward(farm.layers(), x, SPEC, device="cpu")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    keys = sorted(k[2] for k in csim.capture_counts())
    assert keys == [(8, 1, 41), (16, 1, 41)]
    assert set(csim.capture_counts().values()) == {1}


def test_farm_envelope_views_are_contiguous_and_updated_in_place():
    """Each stage's (C, T_s) replicas are one contiguous view of the
    chip-major envelope; every launch of a step reads and writes those
    views (never a copy), eager or compiled, and the placement shows
    chip 0's replica."""
    C = 3
    farm = build_farm("mnist_class", C, seed=0, device="cpu")
    st = farm._stacks
    assert st.chips == C and st.g_plus.shape[1] == C * st.T_max
    ptrs = (st.g_plus.data_ptr(), st.g_minus.data_ptr())
    seen = []

    class Spy:
        """Stands in for the ops module and records the conductance
        operands of the launches that take them."""

        def __getattr__(self, name):
            fn = getattr(tops, name)

            def call(*args, **kwargs):
                if name in ("crossbar_fwd_stacked", "crossbar_bwd_stacked"):
                    seen.append(args[1])
                return fn(*args, **kwargs)
            return call
    x, t = _x(784, 6, 1), _x(10, 6, 2)
    csim.kernel_ops = Spy()
    try:
        farm.train_step(x, t, lr=0.1)
    finally:
        csim.kernel_ops = tops
    assert len(seen) == 2 * st.S
    env = {st.g_plus[s, :C * m.T].data_ptr()
           for s, m in enumerate(st.stage_maps)}
    assert all(g.is_contiguous() and g.data_ptr() in env for g in seen)
    for s, m in enumerate(st.stage_maps):
        gp, gm = st.chip_views(s)
        assert gp.is_contiguous() and gp.shape == (C, m.T, 400, 100)
        assert farm._gp[s].data_ptr() == gp.data_ptr()
        assert farm.placement.stages[s].g_plus.data_ptr() == gp.data_ptr()
        for c in range(C):        # chip-major: replica c's T_s cores
            assert torch.equal(st.g_plus[s, c * m.T:(c + 1) * m.T], gp[c])
    eager = build_farm("mnist_class", C, seed=0, device="cpu",
                       compiled=False)
    eager.train_step(x, t, lr=0.1)
    assert farm.replicas_in_sync() and eager.replicas_in_sync()
    assert (st.g_plus.data_ptr(), st.g_minus.data_ptr()) == ptrs
    before = [g.clone() for g in eager._gp]
    eager.train_step(x, t, lr=0.1)
    assert eager._stacks.g_plus.data_ptr() == \
        eager._gp[0].data_ptr()
    assert any(not torch.equal(a, b) for a, b in zip(before, eager._gp))
