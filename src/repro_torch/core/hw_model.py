"""Analytic hardware model reproducing the paper's Tables II-IV, Figs 22-25.

All constants come from the paper text (sections IV-VI).  The model prices a
network mapped by :mod:`repro.core.mapping` and compares against the paper's
NVIDIA Tesla K20 baseline.  Where the paper does not state a constant (K20
achieved utilization), the assumption is documented inline.

This module is *descriptive* (it reproduces the paper's claims); the TPU
roofline in launch/roofline.py is the *prescriptive* performance model for
the scaled system.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.mapping import (NetworkMap, map_autoencoder_pretraining,
                                map_network, split_network)

# ----- paper constants -----------------------------------------------------
CROSSBAR_EVAL_NS = 20.0            # "crossbar required 20 ns to be evaluated"
ROUTING_CLOCK_HZ = 200e6           # "routing would run at 200 MHz"
ROUTING_CYCLES_PER_XBAR = 4        # "4 cycles needed for crossbar processing"
LINK_BITS = 8                      # "assuming 8 bits per link"
TSV_PJ_PER_BIT = 0.05              # "0.05 pJ/bit" off-chip IO

# Table II: single memristor core, per execution step.
FWD_US, FWD_MW = 0.27, 0.794
BWD_US, BWD_MW = 0.80, 0.706
UPD_US, UPD_MW = 1.00, 6.513
CTRL_MW = 0.0004

CORE_AREA_MM2 = 0.0163
CLUSTER_AREA_MM2 = 0.039
CLUSTER_POWER_MW = 1.36
CLUSTER_EPOCH_1000_US = 0.32       # k-means: 1000 samples, one epoch
RISC_AREA_MM2 = 0.52
SYSTEM_CORES = 144
SYSTEM_AREA_MM2 = 2.94

# GPU baseline (section VI.F).
GPU_POWER_W = 225.0
GPU_AREA_MM2 = 561.0
GPU_PEAK_FLOPS = 3.52e12           # K20 fp32 peak
GPU_UTILIZATION = 0.10             # assumption: achieved fraction of peak for
                                   # small-batch MLP training (not in paper)
GPU_LAUNCH_US_PER_PASS = 10.0      # assumption: kernel launch + HBM round
                                   # trip per layer-pass at streaming batch
                                   # size 1 (the paper's setting) — tiny
                                   # MLPs are launch-bound on a K20

ADC_BITS_OUT = 3

# ----- chip-farm host link (NOT in the paper — DESIGN.md §6) ---------------
# The multi-chip farm (repro.sim.cluster) hangs N chips off a host over a
# serial link.  The paper prices only the per-chip TSV IO; the farm adds a
# host-side hop.  Assumptions, documented here because the paper is silent:
# a PCIe-class lane per chip (16 Gbit/s effective) at typical off-package
# SerDes energy (5 pJ/bit — two orders above the 3D-stacked TSV, which is
# the point of keeping training traffic in 8-bit codes).
HOST_LINK_GBPS = 16.0              # effective per-chip host-link bandwidth
HOST_LINK_PJ_PER_BIT = 5.0         # off-package SerDes energy per bit
ERR_BITS_LINK = 8                  # reconciliation codes (paper III.F)

# ----- inter-chip pipeline link (NOT in the paper — DESIGN.md §7) ----------
# The pipeline fabric (repro.sim.fabric) chains chips when a network's core
# count exceeds one chip's budget.  Chip-boundary traffic obeys the same
# quantize-at-the-boundary rule as the on-chip NoC: activations cross as
# 3-bit output-ADC codes forward, errors as 8-bit sign-magnitude codes
# backward.  The link itself is priced as the same PCIe-class SerDes hop as
# the farm's host link (assumption, documented because the paper is silent
# on multi-chip networks).
INTERCHIP_GBPS = HOST_LINK_GBPS
INTERCHIP_PJ_PER_BIT = HOST_LINK_PJ_PER_BIT


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """Time and core energy of one execution phase (per sample)."""
    time_us: float
    energy_j: float


@dataclasses.dataclass(frozen=True)
class AppCost:
    """Per-sample analytic cost of one application on one chip: a training
    iteration (`train`) and a recognition pass (`infer`), core energy and
    off-chip TSV IO separated (Table III's columns)."""
    name: str
    cores: int
    train: PhaseCost
    infer: PhaseCost
    io_energy_train_j: float
    io_energy_infer_j: float

    @property
    def train_total_j(self) -> float:
        """Training energy per sample including off-chip IO."""
        return self.train.energy_j + self.io_energy_train_j

    @property
    def infer_total_j(self) -> float:
        """Recognition energy per sample including off-chip IO."""
        return self.infer.energy_j + self.io_energy_infer_j


def _io_energy(bits: float) -> float:
    return bits * TSV_PJ_PER_BIT * 1e-12


def core_step_energy_j(time_us: float, power_mw: float, cores: int) -> float:
    """Energy of ``cores`` cores running one ``time_us`` step at
    ``power_mw`` each (Table II row x core count)."""
    return time_us * 1e-6 * power_mw * 1e-3 * cores


def network_cost(name: str, dims: list[int], *, pretraining: bool = False,
                 input_bits: int = 8,
                 share_small_layers: bool = False,
                 rows: int | None = None, cols: int | None = None
                 ) -> AppCost:
    """Cost one training iteration + one recognition pass for a network.

    Training = forward + backward + update on every layer's cores, phases
    serialized across layers (the layers of one sample execute in sequence),
    plus routing of neuron outputs and off-chip IO of the input sample.

    The same counting is reproduced from *measured* counters by the virtual
    chip (``repro.sim.report``); ``tests/test_chip_sim.py`` pins the two to
    1% agreement (DESIGN.md "Virtual chip" cross-validation contract).
    """
    from repro_torch.core.mapping import CORE_COLS, CORE_ROWS
    rows = CORE_ROWS if rows is None else rows
    cols = CORE_COLS if cols is None else cols
    nmap: NetworkMap = (
        map_autoencoder_pretraining(dims, rows, cols,
                                    share_small_layers=share_small_layers)
        if pretraining
        else map_network(dims, rows, cols,
                         share_small_layers=share_small_layers))
    n_layers = len(nmap.layers)

    route_us = nmap.routed_outputs / ROUTING_CLOCK_HZ * 1e6

    # --- training: each layer does fwd, bwd, update (Table II timings);
    # layers serialize, phases within a layer serialize.
    train_us = n_layers * (FWD_US + BWD_US + UPD_US) + route_us
    train_j = 0.0
    for lm in nmap.layers:
        train_j += core_step_energy_j(FWD_US, FWD_MW, lm.total_cores)
        train_j += core_step_energy_j(BWD_US, BWD_MW, lm.total_cores)
        train_j += core_step_energy_j(UPD_US, UPD_MW, lm.total_cores)
        train_j += core_step_energy_j(train_us, CTRL_MW, lm.total_cores)

    # --- recognition: forward only; layers pipeline (paper: one 20ns eval +
    # 4 routing cycles each, fully overlapped at steady state).
    infer_us = n_layers * FWD_US + route_us
    infer_j = sum(core_step_energy_j(FWD_US, FWD_MW, lm.total_cores)
                  for lm in nmap.layers)

    io_bits = dims[0] * input_bits
    out_bits = dims[-1] * ADC_BITS_OUT
    return AppCost(
        name=name, cores=nmap.cores,
        train=PhaseCost(train_us, train_j),
        infer=PhaseCost(infer_us, infer_j),
        io_energy_train_j=_io_energy(io_bits * 2 + out_bits),
        io_energy_infer_j=_io_energy(io_bits + out_bits),
    )


def pipeline_beat_us(slot_cycles: int = 100) -> float:
    """Steady-state recognition beat (Table IV): one crossbar evaluation
    slot plus one static routing slot of ``slot_cycles`` cycles — 0.27 +
    100/200 MHz = 0.77 us for the paper geometry, every application."""
    return FWD_US + slot_cycles / ROUTING_CLOCK_HZ * 1e6


# ----- chip farm: N chips under one host (DESIGN.md §6) --------------------

@dataclasses.dataclass(frozen=True)
class FarmCost:
    """Analytic cost of an N-chip data-parallel farm.

    Serving: each chip streams one sample per pipeline beat; the host link
    carries the sample in and the ADC codes out.  Training: each chip runs
    the three phases on its batch shard, then the host link reconciles the
    pulse updates (local outer-product codes up, reconciled pulses down,
    ``ERR_BITS_LINK`` bits per placed crossbar cell each way)."""
    name: str
    n_chips: int
    chip: AppCost
    beat_us: float
    serve_samples_per_s: float        # aggregate steady-state throughput
    serve_j_per_sample: float         # chip core + TSV + host-link energy
    host_bits_infer: int              # host-link bits per served sample
    host_bits_train: int              # host-link bits per training sample
    reconcile_bits: int               # per chip per step, both directions
    host_link_utilization: float      # serve: bits-time / beat per chip;
                                      # > 1 flags a link-bound farm (the
                                      # beat-rate is then unachievable)
    train_step_us: float              # one farm step (batch_per_chip each)
    train_j_per_sample: float         # per global sample, incl. host link

    @property
    def serve_w(self) -> float:
        """Steady-state serving power of the whole farm (J/sample x
        samples/s)."""
        return self.serve_j_per_sample * self.serve_samples_per_s


def _host_link_us(bits: float) -> float:
    return bits / (HOST_LINK_GBPS * 1e9) * 1e6


def _host_link_j(bits: float) -> float:
    return bits * HOST_LINK_PJ_PER_BIT * 1e-12


def farm_cost(name: str, dims: list[int], n_chips: int, *,
              batch_per_chip: int = 1, input_bits: int = 8,
              share_small_layers: bool = False,
              rows: int | None = None, cols: int | None = None) -> FarmCost:
    """Price an N-chip farm serving and training ``dims``.

    The same quantities are reproduced from *measured* counters by the
    farm simulator (``repro.sim.cluster`` / ``sim.report.FarmReport``);
    ``tests/test_farm.py`` pins the two to 1% agreement, extending the
    single-chip cross-validation contract (DESIGN.md §5.3) to the farm.
    """
    from repro_torch.core.mapping import CORE_COLS, CORE_ROWS
    rows = CORE_ROWS if rows is None else rows
    cols = CORE_COLS if cols is None else cols
    chip = network_cost(name, dims, input_bits=input_bits,
                        share_small_layers=share_small_layers,
                        rows=rows, cols=cols)
    nmap = map_network(dims, rows, cols,
                       share_small_layers=share_small_layers)
    beat = pipeline_beat_us(cols)

    # serving: per-sample host traffic mirrors the chip's TSV convention
    # (input sample in, output ADC codes back).  The farm simulator's
    # serving loop retires one sample per chip per beat and does NOT model
    # host-link stalls, so the analytic side prices the same idealization:
    # throughput is beat-limited, and a link-bound configuration is
    # *flagged* by host_link_utilization > 1 rather than silently
    # re-priced (keeps the <=1% sim<->model contract exact for all nets).
    host_infer = dims[0] * input_bits + dims[-1] * ADC_BITS_OUT
    link_us = _host_link_us(host_infer)
    serve_sps = n_chips * 1e6 / beat
    # steady-state energy/sample: every stage busy -> the full forward core
    # energy is spent per retired sample; TSV + host link add transport.
    serve_j = chip.infer.energy_j + chip.io_energy_infer_j \
        + _host_link_j(host_infer)

    # training: dw codes for every placed main-grid cell, both directions.
    cells = sum(lm.row_tiles * lm.col_tiles for lm in nmap.layers) \
        * rows * cols
    reconcile_bits = 2 * cells * ERR_BITS_LINK
    host_train = 2 * dims[0] * input_bits + dims[-1] * ADC_BITS_OUT
    train_step_us = batch_per_chip * chip.train.time_us \
        + _host_link_us(reconcile_bits)
    global_batch = n_chips * batch_per_chip
    train_j = chip.train.energy_j + chip.io_energy_train_j \
        + _host_link_j(host_train) \
        + n_chips * _host_link_j(reconcile_bits) / global_batch
    return FarmCost(
        name=name, n_chips=n_chips, chip=chip, beat_us=beat,
        serve_samples_per_s=serve_sps, serve_j_per_sample=serve_j,
        host_bits_infer=host_infer, host_bits_train=host_train,
        reconcile_bits=reconcile_bits,
        host_link_utilization=link_us / beat,
        train_step_us=train_step_us, train_j_per_sample=train_j)


# ----- pipeline fabric: a network split ACROSS chips (DESIGN.md §7) --------

def schedule_1f1b(fwd_us: list[float], bwd_us: list[float],
                  link_fwd_us: list[float], link_bwd_us: list[float],
                  n_micro: int) -> float:
    """Span (us) of a 1F1B pipeline schedule over K chips.

    ``fwd_us[k]`` / ``bwd_us[k]`` are chip ``k``'s per-microbatch slice
    times (bwd includes the update phase — the paper's training unit runs
    bwd and update back to back per layer, Table II); ``link_fwd_us[k]`` /
    ``link_bwd_us[k]`` the inter-chip transfer time across boundary
    ``k -> k+1`` (length K-1).  The schedule is the standard one-forward-
    one-backward discipline: chip ``k`` admits ``min(n_micro, K - k)``
    warmup forwards, then strictly alternates backward/forward until both
    streams drain.  Computed by memoized recursion over op finish times
    (each chip serializes its own ops; cross-chip deps add link time), so
    the same function prices the analytic model AND the measured-counter
    schedule — one owner of the recurrence, two inputs to cross-validate.

    With ``n_micro == 1`` the span degenerates to the serialized wave:
    ``sum(fwd) + sum(bwd) + all link hops``.
    """
    K = len(fwd_us)
    if K == 1:
        return n_micro * (fwd_us[0] + bwd_us[0])
    order: list[list[tuple[str, int]]] = []
    for k in range(K):
        w = min(n_micro, K - k)
        ops = [("F", j) for j in range(w)]
        f, b = w, 0
        while f < n_micro or b < n_micro:
            if b < n_micro:
                ops.append(("B", b))
                b += 1
            if f < n_micro:
                ops.append(("F", f))
                f += 1
        order.append(ops)
    pos = [{op: i for i, op in enumerate(ops)} for ops in order]
    memo: dict[tuple, float | None] = {}

    def finish(k: int, kind: str, j: int) -> float:
        key = (k, kind, j)
        if key in memo:
            if memo[key] is None:
                raise RuntimeError("1F1B schedule has a dependency cycle")
            return memo[key]
        memo[key] = None
        i = pos[k][(kind, j)]
        ready = finish(k, *order[k][i - 1]) if i else 0.0
        if kind == "F":
            dep = finish(k - 1, "F", j) + link_fwd_us[k - 1] if k else 0.0
            dur = fwd_us[k]
        else:
            dep = (finish(k + 1, "B", j) + link_bwd_us[k] if k < K - 1
                   else finish(K - 1, "F", j))
            dur = bwd_us[k]
        memo[key] = max(ready, dep) + dur
        return memo[key]

    return max(finish(k, *order[k][-1]) for k in range(K))


@dataclasses.dataclass(frozen=True)
class PipelineCost:
    """Analytic cost of a K-chip pipeline-parallel fabric.

    The network's pipeline stages are partitioned contiguously over chips
    (``mapping.split_network``); activations cross each chip boundary as
    3-bit output-ADC codes, errors come back as 8-bit sign-magnitude codes
    (the NoC's quantize-at-the-boundary rule, lifted to the inter-chip
    link).  Serving keeps the Table IV beat — a boundary hop rides inside
    the routing slot, flagged by ``link_utilization`` when it would not
    fit; training is priced as the executed full-batch wave
    (``train_step_us``) plus the 1F1B schedule span (``span_us``) for the
    requested microbatch count."""
    name: str
    n_chips: int
    stage_groups: tuple[tuple[int, ...], ...]   # layer indices per chip
    cores_per_chip: tuple[int, ...]
    chip: AppCost                     # the UNSPLIT serial network's cost
    beat_us: float
    boundary_dims: tuple[int, ...]    # activation width at each boundary
    link_bits_fwd: int                # per sample, all boundaries, 3b codes
    link_bits_bwd: int                # per sample, all boundaries, 8b codes
    serve_latency_us: float           # S stage hops at one beat each
    serve_samples_per_s: float        # one pipeline: 1 sample per beat
    serve_j_per_sample: float         # chip + TSV + inter-chip link energy
    link_utilization: float           # busiest boundary: link time / beat
    train_step_us: float              # executed wave over the global batch
    train_j_per_sample: float
    span_us: float                    # 1F1B schedule span for n_micro
    bubble_fraction: float            # idle fraction of the 1F1B schedule
    n_micro: int
    batch: int


def _interchip_us(bits: float) -> float:
    return bits / (INTERCHIP_GBPS * 1e9) * 1e6


def _interchip_j(bits: float) -> float:
    return bits * INTERCHIP_PJ_PER_BIT * 1e-12


def pipeline_cost(name: str, dims: list[int], *,
                  max_cores_per_chip: int | None = None,
                  n_chips: int | None = None,
                  batch: int = 1, n_micro: int = 1, input_bits: int = 8,
                  share_small_layers: bool = False,
                  rows: int | None = None, cols: int | None = None
                  ) -> PipelineCost:
    """Price a pipeline-parallel fabric executing ``dims`` across chips.

    The same quantities are reproduced from *measured* counters by the
    fabric simulator (``repro.sim.fabric`` / ``sim.report.PipelineReport``);
    ``tests/test_pipeline_fabric.py`` pins the two to 1% agreement — the
    §5.3 cross-validation contract extended to the inter-chip link.
    """
    from repro_torch.core.mapping import CORE_COLS, CORE_ROWS
    rows = CORE_ROWS if rows is None else rows
    cols = CORE_COLS if cols is None else cols
    chip = network_cost(name, dims, input_bits=input_bits,
                        share_small_layers=share_small_layers,
                        rows=rows, cols=cols)
    nmap = map_network(dims, rows, cols,
                       share_small_layers=share_small_layers)
    groups = split_network(nmap, max_cores_per_chip=max_cores_per_chip,
                           n_chips=n_chips)
    K = len(groups)
    beat = pipeline_beat_us(cols)

    # per-chip slice times (per sample): phases + the slice's routing
    fwd_us, bwd_us = [], []
    cores_per_chip = []
    for g in groups:
        lms = [nmap.layers[i] for i in g]
        route = sum(lm.routed_outputs for lm in lms) / ROUTING_CLOCK_HZ * 1e6
        fwd_us.append(len(lms) * FWD_US + route)
        bwd_us.append(len(lms) * (BWD_US + UPD_US))
        cores_per_chip.append(sum(lm.placed_cores for lm in lms))

    # chip-boundary traffic: the activation width leaving each group
    boundary_dims = tuple(dims[g[-1] + 1] for g in groups[:-1])
    bits_fwd = sum(d * ADC_BITS_OUT for d in boundary_dims)
    bits_bwd = sum(d * ERR_BITS_LINK for d in boundary_dims)

    # serving: the beat is unchanged (a boundary hop rides inside the
    # static routing slot); a hop that would NOT fit is flagged by
    # link_utilization > 1 rather than silently re-priced — the same
    # idealization discipline as the farm's host link.
    link_util = max(
        (_interchip_us(d * ADC_BITS_OUT) / beat for d in boundary_dims),
        default=0.0)
    serve_j = chip.infer_total_j + _interchip_j(bits_fwd)

    # training: the executed schedule is a full-batch wave (numerics equal
    # the serial chip); 1F1B staggering is the *time* model for microbatch
    # pipelining, priced by the shared schedule recurrence.
    train_step_us = batch * chip.train.time_us \
        + _interchip_us(batch * (bits_fwd + bits_bwd))
    train_j = chip.train_total_j + _interchip_j(bits_fwd + bits_bwd)
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    u = batch // n_micro
    link_f = [u * _interchip_us(d * ADC_BITS_OUT) for d in boundary_dims]
    link_b = [u * _interchip_us(d * ERR_BITS_LINK) for d in boundary_dims]
    span = schedule_1f1b([u * t for t in fwd_us], [u * t for t in bwd_us],
                         link_f, link_b, n_micro)
    busy = sum(batch * (f + b) for f, b in zip(fwd_us, bwd_us))
    return PipelineCost(
        name=name, n_chips=K, stage_groups=groups,
        cores_per_chip=tuple(cores_per_chip), chip=chip, beat_us=beat,
        boundary_dims=boundary_dims,
        link_bits_fwd=bits_fwd, link_bits_bwd=bits_bwd,
        serve_latency_us=len(nmap.layers) * beat,
        serve_samples_per_s=1e6 / beat,
        serve_j_per_sample=serve_j,
        link_utilization=link_util,
        train_step_us=train_step_us, train_j_per_sample=train_j,
        span_us=span, bubble_fraction=1.0 - busy / (K * span) if span else 0.0,
        n_micro=n_micro, batch=batch)


def gpu_cost(dims: list[int], *, train: bool) -> PhaseCost:
    """Estimate K20 time/energy for one sample (documented assumptions:
    GPU_UTILIZATION of fp32 peak; training = 3x forward FLOPs; plus a
    per-layer-pass launch/latency floor that dominates for the paper's
    streaming batch-1 MLPs)."""
    mults = sum(i * o for i, o in zip(dims, dims[1:]))
    passes = (3 if train else 1) * (len(dims) - 1)
    flops = 2 * mults * (3 if train else 1)
    t = flops / (GPU_PEAK_FLOPS * GPU_UTILIZATION) \
        + passes * GPU_LAUNCH_US_PER_PASS * 1e-6
    return PhaseCost(t * 1e6, t * GPU_POWER_W)


def speedup_and_efficiency(app: AppCost, dims: list[int]
                           ) -> dict[str, float]:
    """Chip-vs-K20 speedup and energy-efficiency ratios (the paper's
    Fig. 22-25 headline comparison) for one priced application."""
    g_train = gpu_cost(dims, train=True)
    g_infer = gpu_cost(dims, train=False)
    return {
        "train_speedup": g_train.time_us / app.train.time_us,
        "infer_speedup": g_infer.time_us / app.infer.time_us,
        "train_energy_eff": g_train.energy_j / app.train_total_j,
        "infer_energy_eff": g_infer.energy_j / app.infer_total_j,
    }


# Paper Table III/IV reference rows for comparison printing.
PAPER_TABLE_III = {
    "mnist_class":   dict(cores=57, time_us=7.29, total_j=4.26e-7),
    "mnist_ae":      dict(cores=57, time_us=17.99, total_j=8.45e-7),
    "isolet_ae":     dict(cores=132, time_us=24.41, total_j=1.99e-6),
    "isolet_class":  dict(cores=132, time_us=8.86, total_j=9.94e-7),
    "kdd_anomaly":   dict(cores=1, time_us=4.15, total_j=1.18e-8),
}
PAPER_TABLE_IV = {
    "mnist_class":   dict(time_us=0.77, total_j=2.26e-8),
    "isolet_class":  dict(time_us=0.77, total_j=5.94e-8),
    "kdd_anomaly":   dict(time_us=0.77, total_j=4.73e-9),
}

# Table I network configurations.
PAPER_NETWORKS = {
    "mnist_class": [784, 300, 200, 100, 10],
    "mnist_ae": [784, 300, 200, 100, 20],
    "isolet_class": [617, 2000, 1000, 500, 250, 26],
    "isolet_ae": [617, 2000, 1000, 500, 250, 20],
    "kdd_anomaly": [41, 15, 41],
}
