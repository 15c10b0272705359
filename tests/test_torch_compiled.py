"""Port parity: the compiled executor (``repro_torch.sim.compiled``, the
port `VirtualChip`'s default) on the CPU, where its stage loop runs the
kernels' plain versions, against the reference's default compiled chip
(``repro.sim.VirtualChip`` with ``REPRO_SIM_COMPILED`` unset) and against
the port's own eager path (``compiled=False``), on the reference's drawn
conductances carried across with ``repro_torch.interop``.

Cases: kdd_anomaly (41-15-41) and mnist_class at full width
(784-300-200-100-10, 13 cores); the layout also for isolet_class (160
cores) and kdd with loopback-shared small layers.  Tolerances: fp32 values
within 1e-6 (the sums run in other orders; the measured gap is ~1e-8);
3-bit activation codes may differ only within 1e-6 of a half-step
boundary; conductances within 1e-6 except where the plain unrounded pulse
count lies within 1e-4 of a half-integer, where one pulse may round the
other way (u/2 = 1.95e-4); index maps, geometry, counters and report fields
exactly equal.  Port against port, compiled against eager holds to the
same tolerances, and a pipeline slice against the full network is bitwise
(the ROADMAP's envelope-invariance pin).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import crossbar as jxb  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.sim import VirtualChip as JaxChip  # noqa: E402
from repro.sim import placer as jpl  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import crossbar as txb  # noqa: E402
from repro_torch.core import mapping as tmap  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402
from repro_torch.sim import compiled as csim  # noqa: E402
from repro_torch.sim import placer as tpl  # noqa: E402

ATOL = 1e-6
BOUNDARY = 1e-6
SCALE3 = 1.0 / 7
PULSE_BOUNDARY = 1e-4
HALF_U = 0.5 * 0.05 / 128
LR = 0.1

CASES = {
    "kdd_anomaly": dict(dims=[41, 15, 41], n=4),
    "mnist_class": dict(dims=[784, 300, 200, 100, 10], n=3),
}
LAYOUTS = {
    "mnist_class": ([784, 300, 200, 100, 10], False),
    "isolet_class": ([617, 2000, 1000, 500, 250, 26], False),
    "kdd_anomaly": ([41, 15, 41], False),
    "kdd_anomaly_shared": ([41, 15, 41], True),
}


@pytest.fixture
def compiled_reference(monkeypatch):
    """The reference chip's default path: its compiled executor."""
    monkeypatch.delenv("REPRO_SIM_COMPILED", raising=False)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _np_layers(dims, seed=0):
    key = jax.random.PRNGKey(seed)
    jl = [jxb.init_conductances(jax.random.fold_in(key, i), f, o,
                                japps.PAPER_SPEC)
          for i, (f, o) in enumerate(zip(dims, dims[1:]))]
    return jl, [{k: np.asarray(v) for k, v in p.items()} for p in jl]


def _data(dims, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, dims[0])).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, dims[-1])).astype(np.float32))


def _port(np_layers, **kw):
    return VirtualChip(interop.layers_from_numpy(np_layers, "cpu"),
                       tapps.PAPER_SPEC, device="cpu", **kw)


def _counters(c):
    return (c.samples, dict(c.slots), dict(c.core_steps), c.io_bits,
            c.noc.slot_cycles,
            [dataclasses.astuple(r) for r in c.noc.records])


def plain_counts(layers, x, target, lr):
    """The paper rule's unrounded pulse counts per layer (float64)."""
    spec = tapps.PAPER_SPEC
    acts, dps, h = [], [], torch.from_numpy(x)
    for li, p in enumerate(layers):
        if li > 0:
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
            assert np.all(d[~near] <= ATOL), (li, k, d[~near].max())
            assert np.all(d[near] <= HALF_U + ATOL), (li, k)


def assert_wave_match(got, want):
    """(acts, dps, out) of two waves: stage inputs compared as 3-bit codes
    (a flip only next to a half-step boundary, its sample excused
    downstream), everything else within ATOL."""
    (ta, td, to), (ja, jd, jo) = got, want
    M = _np(jo).shape[0]
    flipped = np.zeros(M, bool)
    for s in range(len(jd)):
        a, b = _np(ta[s]), _np(ja[s])
        if s == 0:
            np.testing.assert_array_equal(a, b)
        else:
            pre = np.clip(_np(jd[s - 1]) * 0.25, -0.5, 0.5)
            u = (pre + 0.5) / SCALE3
            diff = np.rint(a / SCALE3 + 3.5) != np.rint(b / SCALE3 + 3.5)
            near = np.abs(u - np.floor(u) - 0.5) * SCALE3 < BOUNDARY
            assert not np.any(diff & ~near & ~flipped[:, None])
            flipped |= diff.any(axis=1)
        ok = ~flipped
        np.testing.assert_allclose(a[ok], b[ok], atol=ATOL)
        np.testing.assert_allclose(_np(td[s])[ok], _np(jd[s])[ok],
                                   atol=ATOL)
    np.testing.assert_allclose(_np(to)[~flipped], _np(jo)[~flipped],
                               atol=ATOL)


def _drive(chip, x, t, to_input):
    """infer, forward_wave, two train_steps and a backward_update on
    ``chip``; returns what each gave plus the layers after each phase."""
    rec = {"infer": chip.infer(to_input(x)),
           "wave": chip.forward_wave(to_input(x))}
    for step in range(2):
        rec[f"err{step}"] = chip.train_step(to_input(x), to_input(t), LR)
        rec[f"layers{step}"] = [{k: _np(v).copy() for k, v in p.items()}
                                for p in chip.layers()]
    acts, dps, out = chip.forward_wave(to_input(x), train=True)
    rec["bwd"] = chip.backward_update(acts, dps, to_input(t) - out, LR)
    rec["layers2"] = [{k: _np(v).copy() for k, v in p.items()}
                      for p in chip.layers()]
    return rec


def _hold(got, want, np_layers, x, t):
    """Hold two ``_drive`` records against each other."""
    np.testing.assert_allclose(_np(got["infer"]), _np(want["infer"]),
                               atol=ATOL)
    assert_wave_match(got["wave"], want["wave"])
    layers = interop.layers_from_numpy(np_layers, "cpu")
    for step in range(2):
        np.testing.assert_allclose(_np(got[f"err{step}"]),
                                   _np(want[f"err{step}"]), atol=ATOL)
        counts = plain_counts(layers, x, t, LR)
        assert_layers_match(got[f"layers{step}"], want[f"layers{step}"],
                            counts)
        layers = interop.layers_from_numpy(want[f"layers{step}"], "cpu")
    np.testing.assert_allclose(_np(got["bwd"]), _np(want["bwd"]), atol=ATOL)
    assert_layers_match(got["layers2"], want["layers2"],
                        plain_counts(layers, x, t, LR))


# ---------------------------------------------------------------------------
# StageStacks layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_stage_stacks_layout_matches_reference(name):
    dims, shared = LAYOUTS[name]
    jl, np_layers = _np_layers(dims)
    jstack = jpl.build_stage_stacks(jpl.place_network(
        jl, jmap.map_network(dims, share_small_layers=shared)))
    tstack = tpl.build_stage_stacks(tpl.place_network(
        interop.layers_from_numpy(np_layers, "cpu"),
        tmap.map_network(dims, share_small_layers=shared)))
    for f in ("S", "T_max", "r_max", "c_max", "rows", "cols", "L", "N_pad",
              "out_dim", "fan_in", "fan_out", "n_cores", "routed", "links"):
        assert getattr(tstack, f) == getattr(jstack, f), f
    for f in ("in_idx", "ds_idx", "dp_idx", "fold_idx", "prev_idx",
              "core_counts"):
        a, b = _np(getattr(tstack, f)), np.asarray(getattr(jstack, f))
        assert getattr(tstack, f).dtype == torch.int64, f
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(_np(tstack.valid_out),
                                  np.asarray(jstack.valid_out))
    for f in ("g_plus", "g_minus"):
        np.testing.assert_array_equal(_np(getattr(tstack, f)),
                                      np.asarray(getattr(jstack, f)))
    assert set(tstack.index_pytree()) == set(jstack.index_pytree())
    # each stage's own maps are slices of the envelope's (the zero slot of
    # the fan-out lanes moved to the stage's own width)
    for s, m in enumerate(tstack.stage_maps):
        T = m.T
        np.testing.assert_array_equal(
            _np(m.in_idx), _np(tstack.in_idx[s, :T]).reshape(-1))
        np.testing.assert_array_equal(
            _np(m.ds_idx), np.minimum(_np(tstack.ds_idx[s, :T]),
                                      m.fan_out).reshape(-1))
        np.testing.assert_array_equal(
            _np(m.dp_idx), _np(tstack.dp_idx[s, :m.r, :m.fan_out]))
        assert m.cores == tstack.n_cores[s]


def test_sub_placement_matches_reference_and_aliases_stages():
    dims = CASES["mnist_class"]["dims"]
    jl, np_layers = _np_layers(dims)
    jsub = jpl.sub_placement(jpl.place_network(jl), (1, 2))
    pl = tpl.place_network(interop.layers_from_numpy(np_layers, "cpu"))
    tsub = tpl.sub_placement(pl, (1, 2))
    assert tsub.dims == jsub.dims
    assert (tsub.nmap.cores, tsub.nmap.routed_outputs,
            tsub.nmap.routing_cycles) == (jsub.nmap.cores,
                                          jsub.nmap.routed_outputs,
                                          jsub.nmap.routing_cycles)
    assert tsub.stages[0] is pl.stages[1]
    with pytest.raises(ValueError, match="contiguous"):
        tpl.sub_placement(pl, (0, 2))


# ---------------------------------------------------------------------------
# Port compiled against reference compiled, and against port eager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_matches_reference_compiled_chip(name, compiled_reference):
    c = CASES[name]
    jl, np_layers = _np_layers(c["dims"])
    x, t = _data(c["dims"], c["n"], 9)
    jchip = JaxChip(jl, japps.PAPER_SPEC, name=name)
    tchip = _port(np_layers, name=name)
    want = _drive(jchip, x, t, np.asarray)
    got = _drive(tchip, x, t, torch.from_numpy)
    _hold(got, want, np_layers, x, t)
    assert _counters(tchip.infer_counters) == \
        _counters(jchip.infer_counters)
    assert _counters(tchip.train_counters) == \
        _counters(jchip.train_counters)
    assert dataclasses.asdict(tchip.report()) == \
        dataclasses.asdict(jchip.report())


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_matches_eager(name):
    c = CASES[name]
    _, np_layers = _np_layers(c["dims"])
    x, t = _data(c["dims"], c["n"], 11)
    compiled, eager = _port(np_layers), _port(np_layers, compiled=False)
    got = _drive(compiled, x, t, torch.from_numpy)
    want = _drive(eager, x, t, torch.from_numpy)
    _hold(got, want, np_layers, x, t)
    assert _counters(compiled.infer_counters) == \
        _counters(eager.infer_counters)
    assert _counters(compiled.train_counters) == \
        _counters(eager.train_counters)
    assert compiled._stacks is not None and eager._stacks is None


def test_compiled_continuous_update_matches_eager():
    """update_quant=False: the stage loop runs the bwd kernel and the
    plain clipped update on the envelope in place."""
    spec = dataclasses.replace(tapps.PAPER_SPEC, update_quant=False)
    _, np_layers = _np_layers([41, 15, 41], seed=2)
    x, t = _data([41, 15, 41], 3, 4)
    chips = [VirtualChip(interop.layers_from_numpy(np_layers, "cpu"), spec,
                         device="cpu", compiled=flag)
             for flag in (True, False)]
    errs = [c.train_step(x, t, lr=0.3) for c in chips]
    np.testing.assert_allclose(_np(errs[0]), _np(errs[1]), atol=ATOL)
    for a, b in zip(*(c.layers() for c in chips)):
        for k in a:
            np.testing.assert_allclose(_np(a[k]), _np(b[k]), atol=ATOL)


# ---------------------------------------------------------------------------
# One program per (topology, batch); in place; envelope invariance
# ---------------------------------------------------------------------------

def test_one_build_per_topology_and_batch():
    dims = CASES["kdd_anomaly"]["dims"]
    _, np_layers = _np_layers(dims)
    x, t = _data(dims, 4, 3)
    chip = _port(np_layers)
    csim.reset_capture_counts()
    for _ in range(3):
        chip.train_step(x, t, lr=0.1)
        chip.infer(x)
    cfg = chip._cfg
    key_train = ("chip_train", cfg, (4, 41))
    key_infer = ("chip_infer", cfg, (4, 41))
    counts = csim.capture_counts()
    assert counts == {key_train: 1, key_infer: 1}, counts
    # an lr schedule reuses the same program (lr_eff is a device buffer)
    chip.train_step(x, t, lr=0.37)
    assert csim.capture_counts() == counts
    # a new batch size builds exactly one more
    chip.train_step(x[:2], t[:2], lr=0.1)
    counts = csim.capture_counts()
    assert counts[("chip_train", cfg, (2, 41))] == 1
    assert counts[key_train] == 1 and len(counts) == 3
    # a program bakes in its envelope: another chip builds its own
    _port(np_layers).train_step(x, t, lr=0.1)
    assert csim.capture_counts()[key_train] == 2


def test_envelope_updates_in_place_and_layers_see_it():
    dims = CASES["mnist_class"]["dims"]
    _, np_layers = _np_layers(dims)
    x, t = _data(dims, 4, 5)
    chip = _port(np_layers)
    chip.train_step(x, t, lr=0.1)
    st = chip._get_stacks()
    ptrs = (st.g_plus.data_ptr(), st.g_minus.data_ptr())
    before = [{k: v.clone() for k, v in p.items()} for p in chip.layers()]
    for _ in range(2):
        chip.train_step(x, t, lr=0.1)
    assert chip._get_stacks() is st
    assert (st.g_plus.data_ptr(), st.g_minus.data_ptr()) == ptrs
    for s, stage in enumerate(chip.placement.stages):
        T = stage.row_tiles * stage.col_tiles
        assert stage.g_plus.data_ptr() == st.g_plus[s, :T].data_ptr()
        assert stage.g_plus.is_contiguous()
    after = chip.layers()
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(after, before)
               for k in a)
    # the layers are the envelope's current contents
    again = tpl.place_network(after).stages
    for s, stage in enumerate(again):
        T = stage.row_tiles * stage.col_tiles
        assert torch.equal(stage.g_plus, st.g_plus[s, :T])


def test_pipeline_slice_envelope_is_bitwise_invisible():
    """The stages of ``sub_placement(pl, (1, 2))`` run inside their own
    envelope and inside the full network's agree bit for bit, port
    against port: mnist_class split over three sub-chips (0 | 1, 2 | 3),
    the slices' outputs tail-quantized across the links, against the
    unsplit chip — one recognition wave and one training step."""
    dims = CASES["mnist_class"]["dims"]
    _, np_layers = _np_layers(dims)
    x, t = (torch.from_numpy(a) for a in _data(dims, 3, 7))
    full = _port(np_layers)
    pl = tpl.place_network(interop.layers_from_numpy(np_layers, "cpu"))
    chips = [VirtualChip(None, tapps.PAPER_SPEC, device="cpu",
                         placement=tpl.sub_placement(pl, g))
             for g in ((0,), (1, 2), (3,))]
    assert chips[1]._get_stacks().T_max != full._get_stacks().T_max
    h, saved = x, []
    for i, chip in enumerate(chips):
        acts, dps, h = chip.forward_wave(h, train=True,
                                         quantize_tail=i < len(chips) - 1)
        saved.append((acts, dps))
    fa, fd, fo = full.forward_wave(x, count=False)
    sa = [a for acts, _ in saved for a in acts]
    sd = [d for _, dps in saved for d in dps]
    assert all(torch.equal(a, b) for a, b in zip(sa, fa))
    assert all(torch.equal(a, b) for a, b in zip(sd, fd))
    assert torch.equal(h, fo)
    assert torch.equal(chips[1].infer(fa[1], count=False),
                       txb.hard_sigmoid(fd[2]))
    err = full.train_step(x, t, LR)
    delta = t - h
    assert torch.equal(delta, err)
    for chip, (acts, dps) in zip(reversed(chips), reversed(saved)):
        delta = chip.backward_update(acts, dps, delta, LR,
                                     global_batch=x.shape[0])
    for a, b in zip(pl.extract_params(), full.layers()):
        assert torch.equal(a["g_plus"], b["g_plus"])
        assert torch.equal(a["g_minus"], b["g_minus"])


def test_default_is_compiled_and_counts_no_launch_on_cpu():
    dims = CASES["kdd_anomaly"]["dims"]
    _, np_layers = _np_layers(dims)
    x, t = _data(dims, 2, 1)
    chip = _port(np_layers)
    assert chip.compiled
    names = ("crossbar_fwd_stacked", "crossbar_train_stacked",
             "crossbar_bwd_stacked", "pulse_update_stacked")
    before = [getattr(tops, n).launches for n in names]
    chip.infer(x)
    chip.train_step(x, t, lr=0.1)
    assert [getattr(tops, n).launches for n in names] == before
    assert chip._stacks is not None


def test_cli_runs_compiled_on_cpu(capsys):
    from repro_torch.launch import chipsim
    csim.reset_capture_counts()
    chipsim.main(["--app", "kdd_anomaly", "--device", "cpu",
                  "--train-steps", "2", "--batch", "3", "--samples", "4"])
    assert "train step 1" in capsys.readouterr().out
    programs = {k[0] for k in csim.capture_counts()}
    assert programs == {"chip_infer", "chip_train"}
