"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``): the reference's own five tests
mirrored on the port's H100 figures, ``Roofline.to_dict`` field for field
with the reference's constants, the collective parse on the same one-line
HLO strings, ``model_flops_estimate`` and ``inner_loop_flops`` exactly for
every architecture and shape, and the trace counter on a hand-counted
function.
"""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

HLO = """
ENTRY %main {
  %ag = f32[16,4096,896]{2,1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={2}
  %ar = bf16[1024]{0} all-reduce(%y), replica_groups=[1,256]<=[256], to_apply=%add
  %rs = f32[64,32]{1,0} reduce-scatter(%z), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %a2a = (f32[8,16]{1,0}, f32[8,16]{1,0}) all-to-all(%u, %w), replica_groups=[32,8]<=[256]
  %cp = s8[128]{0} collective-permute(%v), source_target_pairs={{0,1}}
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""
OPS = ("all-gather", "all-gather-start", "all-reduce", "all-reduce-start",
       "reduce-scatter", "all-to-all", "collective-permute",
       "collective-permute-start")


def _records(text, n):
    recs = (rl.hlo_line_record(line, n) for line in text.splitlines())
    return [r for r in recs if r is not None]


# ---------------------------------------------------------------------------
# The reference's tests/test_roofline.py, on the port
# ---------------------------------------------------------------------------

def test_collective_bytes_parsing():
    out = rl.collective_bytes(_records(HLO, 256), 256)
    ag = 16 * 4096 * 896 * 4 * 15 / 16
    ar = 1024 * 2 * 2 * 255 / 256
    rs = 64 * 32 * 4 * 15
    a2a = 2 * 8 * 16 * 4 * 7 / 8
    cp = 128 * 1
    assert out["all-gather"] == pytest.approx(ag)
    assert out["all-reduce"] == pytest.approx(ar)
    assert out["reduce-scatter"] == pytest.approx(rs)
    assert out["all-to-all"] == pytest.approx(a2a)
    assert out["collective-permute"] == pytest.approx(cp)
    assert out["total"] == pytest.approx(ag + ar + rs + a2a + cp)


def test_group_size_variants():
    # old-style replica_groups={{0,1},{2,3}} -> group size 2
    line = "%ar = f32[4]{0} all-reduce(%x), replica_groups={{0,1},{2,3}}"
    out = rl.collective_bytes(_records(line, 4), 4)
    assert out["all-reduce"] == pytest.approx(4 * 4 * 2 * 1 / 2)
    # group size 1 -> no wire traffic
    line1 = "%ar = f32[4]{0} all-reduce(%x), replica_groups=[4,1]<=[4]"
    assert rl.collective_bytes(_records(line1, 4), 4)["total"] == 0


def test_roofline_terms_and_bottleneck():
    r = rl.Roofline(flops_per_dev=rl.PEAK_FLOPS, bytes_per_dev=rl.HBM_BW * 2,
                    coll_bytes_per_dev=rl.ICI_BW * 0.5, coll_breakdown={},
                    n_devices=256, model_flops=rl.PEAK_FLOPS * 256 * 0.5)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.t_bound == pytest.approx(2.0)
    assert r.mfu_bound == pytest.approx(0.25)
    assert r.useful_flops_ratio == pytest.approx(0.5)


def test_inner_loop_flops_paths():
    cfg = get_config("yi-6b")
    # dense grid scanned: correction > 0 for train
    f_train = rl.inner_loop_flops(cfg, "train", 4096, 256)
    assert f_train > 0
    # decode: no inner loops
    assert rl.inner_loop_flops(cfg, "decode", 32768, 128) == 0
    # triangular unrolled (nq=8 <= 12): no correction
    cfg_skip = cfg.replace(skip_masked_blocks=True)
    assert rl.inner_loop_flops(cfg_skip, "train", 4096, 256) == 0
    # paired scanned (nq=64): half the dense-grid correction
    f_pref = rl.inner_loop_flops(cfg, "prefill", 32768, 32)
    f_pair = rl.inner_loop_flops(cfg_skip, "prefill", 32768, 32)
    assert 0.4 < f_pair / f_pref < 0.6


def test_model_flops_estimates():
    dense = get_config("yi-6b")
    moe = get_config("qwen3-moe-30b-a3b")
    assert rl.model_flops_estimate(dense, "train", 4096, 256) == \
        6.0 * dense.active_param_count() * 4096 * 256
    # MoE active < total
    assert moe.active_param_count() < 0.25 * moe.param_count()


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

def test_constants_are_the_h100_spec_sheet():
    """The port prices with the H100 SXM5 80GB figures PERF.md uses, none
    of the reference's TPU v5e figures."""
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_FP32, rl.HBM_BW, rl.ICI_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert rl.PEAK_FLOPS != ref_rl.PEAK_FLOPS and rl.HBM_BW != ref_rl.HBM_BW


@pytest.mark.parametrize("fields", [
    (197e12, 819e9 * 2, 50e9 * 0.5, 256, 197e12 * 256 * 0.5),
    (3.1e14, 2.2e11, 7.5e10, 512, 1.0e16),
    (1.0e9, 4.0e12, 0.0, 1, 0.0),
    (0.0, 0.0, 0.0, 8, 5.0),
])
def test_roofline_to_dict_equals_the_reference(monkeypatch, fields):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(rl, name, getattr(ref_rl, name))
    flops, nbytes, coll, n, model = fields
    breakdown = {"all-gather": coll, "total": coll}
    port = rl.Roofline(flops, nbytes, coll, breakdown, n, model)
    ref = ref_rl.Roofline(flops, nbytes, coll, breakdown, n, model)
    assert port.to_dict() == ref.to_dict()
    assert list(port.to_dict()) == list(ref.to_dict())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("S", [1, 2, 16, 256])
def test_collective_bytes_equal_the_reference_per_line(op, S):
    """Each op kind, at group sizes 1 .. 256, in both replica-group
    spellings and with a tuple result: the port's records give the
    reference's per-device wire bytes."""
    n = 256
    lines = [
        f"%c = f32[16,4096,896]{{2,1,0}} {op}(%x), "
        f"replica_groups=[{n // S},{S}]<=[{n}], dimensions={{2}}",
        f"%c = bf16[1024]{{0}} {op}(%y), replica_groups={{{{"
        + ",".join(map(str, range(S))) + "}}, to_apply=%add",
        f"%c = (f32[8,16]{{1,0}}, s8[8,16]{{1,0}}) {op}(%u, %w), "
        f"replica_groups=[{n // S},{S}]<=[{n}]",
        f"%c = u32[7]{{0}} {op}(%v)",          # no groups: all n devices
    ]
    for line in lines + ["\n".join(lines)]:
        assert rl.collective_bytes(_records(line, n), n) == \
            ref_rl.collective_bytes(line, n), line


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_flops_equal_the_reference(arch):
    """``model_flops_estimate`` and ``inner_loop_flops`` equal the
    reference's exactly for every shape, with and without
    ``skip_masked_blocks``."""
    assert list(SHAPES) == list(REF_SHAPES)
    for skip in (False, True):
        port = get_config(arch, skip_masked_blocks=skip)
        ref = ref_config(arch, skip_masked_blocks=skip)
        for shape, info in SHAPES.items():
            assert info == REF_SHAPES[shape]
            args = (info["kind"], info["seq_len"], info["global_batch"])
            assert rl.model_flops_estimate(port, *args) == \
                ref_rl.model_flops_estimate(ref, *args), (shape, skip)
            assert rl.inner_loop_flops(port, *args) == \
                ref_rl.inner_loop_flops(ref, *args), (shape, skip)


# ---------------------------------------------------------------------------
# The trace counter
# ---------------------------------------------------------------------------

def _matmul_add_view(a, b, c):
    return (a @ b + c).view(64)


@pytest.mark.parametrize("fake", [False, True])
def test_cost_counter_counts_a_matmul_an_add_and_a_view(fake):
    """(4, 8) @ (8, 16): 2 * 4 * 8 * 16 = 1024 FLOPs, 128 + 512 + 256
    bytes; + (4, 16): 64 FLOPs, 3 * 256 bytes; the view: nothing.  The
    product's 256 bytes die after the add, whose 256 live on: a peak of
    512 and 256 left; the arguments are not counted."""
    def run():
        a, b, c = torch.ones(4, 8), torch.ones(8, 16), torch.ones(4, 16)
        counter = rl.CostCounter()
        with counter:
            out = _matmul_add_view(a, b, c)
        return counter, out

    if fake:
        with FakeTensorMode():
            counter, out = run()
    else:
        counter, out = run()
    assert out.shape == (64,)
    assert counter.record() == {"flops": 1088, "bytes": 1664,
                                "peak_bytes": 512, "ops": 3}
    assert counter.live_bytes == 256


def test_cost_counter_counts_a_kernel_as_launched():
    """A wrapper's plain version counts as its kernel: the plain forward's
    product, its operands read once and its result written once, and only
    the result held; outside a counter the hook list is empty."""
    x, gp, gm = torch.ones(2, 32, 16), torch.ones(2, 16, 8), \
        torch.zeros(2, 16, 8)
    counter = rl.CostCounter()
    with counter:
        y = ops.crossbar_fwd_stacked(x, gp, gm)
    assert not ops.PLAIN_HOOKS
    assert y.shape == (2, 32, 8)
    assert counter.bytes == 4 * (2 * 32 * 16 + 2 * 2 * 16 * 8 + 2 * 32 * 8)
    assert counter.flops >= 2 * 2 * 32 * 16 * 8
    assert counter.peak_bytes == counter.live_bytes == y.nbytes
