"""SimReport: measured simulator counters -> time / energy / throughput.

The virtual chip never *prices* anything while executing — it only counts:
phase executions (which cores ran fwd/bwd/update, Table II), NoC transports
(`sim/noc.py`), and off-chip IO bits.  This module turns those counters
into per-sample time and energy using the same paper constants as
`core/hw_model.py`, which makes the analytic model a *checked claim*: the
cross-validation contract (DESIGN.md "Virtual chip") pins

    sim measured time/energy  ==  hw_model analytic time/energy  (<= 1%)

for one training step and one recognition pass, asserted in
``tests/test_chip_sim.py`` and recorded in ``BENCH_sim.json``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import hw_model as hw
from repro_torch.sim.noc import NocTracker

PHASE_US = {"fwd": hw.FWD_US, "bwd": hw.BWD_US, "update": hw.UPD_US}
PHASE_MW = {"fwd": hw.FWD_MW, "bwd": hw.BWD_MW, "update": hw.UPD_MW}


def _rel(a: float, b: float) -> float:
    """Relative error |a-b|/|b| (absolute when the reference is 0) — the
    single zero-handling convention behind every <=1% cross-validation
    gate in this module."""
    return abs(a - b) / abs(b) if b else abs(a)


@dataclasses.dataclass
class PhaseCounters:
    """Execution counters for one mode (inference or training)."""
    noc: NocTracker
    samples: int = 0
    slots: dict = dataclasses.field(
        default_factory=lambda: {"fwd": 0, "bwd": 0, "update": 0})
    core_steps: dict = dataclasses.field(
        default_factory=lambda: {"fwd": 0, "bwd": 0, "update": 0})
    io_bits: int = 0

    def record_phase(self, phase: str, cores: int, samples: int) -> None:
        """One serialized time slot of ``phase`` on ``cores`` cores for each
        of ``samples`` samples (an aggregation sub-stage executes inside its
        layer's slot — its cores are included in ``cores``, not billed an
        extra slot; same convention as the analytic model)."""
        self.slots[phase] += samples
        self.core_steps[phase] += cores * samples

    def record_io(self, bits: int, samples: int) -> None:
        """Off-chip TSV IO: ``bits`` per sample for ``samples`` samples."""
        self.io_bits += bits * samples

    # ---- per-sample derived quantities ---------------------------------

    def route_us(self) -> float:
        """Per-sample serialized routing time (hw_model convention)."""
        return self.noc.route_us_per_sample(self.samples)

    def time_us(self) -> float:
        """Serialized per-sample latency: phase slots + routing (the
        analytic model's convention: phases serialize across layers)."""
        n = max(self.samples, 1)
        t = sum(self.slots[p] / n * PHASE_US[p] for p in self.slots)
        return t + self.route_us()

    def core_energy_j(self, include_ctrl: bool = False) -> float:
        """Per-sample core energy from the phase counters (Table II rows);
        ``include_ctrl`` adds the control-logic draw over the whole step."""
        n = max(self.samples, 1)
        e = sum(hw.core_step_energy_j(PHASE_US[p], PHASE_MW[p],
                                      self.core_steps[p] / n)
                for p in self.core_steps)
        if include_ctrl:
            # control logic burns CTRL_MW on every core of every placed
            # layer for the whole step; the per-sample fwd core-steps ARE
            # sum(total_cores) over layers, measured.
            e += hw.core_step_energy_j(self.time_us(), hw.CTRL_MW,
                                       self.core_steps["fwd"] / n)
        return e

    def io_energy_j(self) -> float:
        """Per-sample off-chip TSV IO energy."""
        return hw._io_energy(self.io_bits / max(self.samples, 1))


@dataclasses.dataclass
class HostLinkTracker:
    """Measured host<->chip traffic of the farm (DESIGN.md §6).

    Counts only — like the NoC tracker, pricing happens at report time with
    the `hw_model` host-link constants.  ``sample_bits`` is per-direction
    sample traffic (inputs in, output ADC codes back, mirroring the chip's
    TSV convention); ``reconcile_bits`` is training-update reconciliation
    traffic (local dw codes up + reconciled pulses down, all chips)."""
    gbps: float = hw.HOST_LINK_GBPS
    pj_per_bit: float = hw.HOST_LINK_PJ_PER_BIT
    sample_bits: int = 0
    reconcile_bits: int = 0
    samples: int = 0
    steps: int = 0

    def record_samples(self, bits_per_sample: int, samples: int) -> None:
        """Per-sample ingress/egress traffic (inputs in, ADC codes back)."""
        self.sample_bits += bits_per_sample * samples
        self.samples += samples

    def record_reconcile(self, bits: int) -> None:
        """One training step's update-reconciliation traffic (all chips)."""
        self.reconcile_bits += bits
        self.steps += 1

    @property
    def total_bits(self) -> int:
        """All bits the host link carried (samples + reconciliation)."""
        return self.sample_bits + self.reconcile_bits

    def time_us(self, bits: float) -> float:
        """Transfer time of ``bits`` at the link's effective bandwidth."""
        return bits / (self.gbps * 1e9) * 1e6

    def energy_j(self, bits: float) -> float:
        """SerDes energy of moving ``bits`` over the link."""
        return bits * self.pj_per_bit * 1e-12

    def sample_bits_per_sample(self) -> float:
        """Measured per-sample host traffic (bits)."""
        return self.sample_bits / max(self.samples, 1)

    def reconcile_bits_per_step(self) -> float:
        """Measured per-step reconciliation traffic (bits, all chips)."""
        return self.reconcile_bits / max(self.steps, 1)


@dataclasses.dataclass
class InterChipLinkTracker:
    """Measured chip-boundary traffic of the pipeline fabric (DESIGN.md §7).

    Counts only, like the NoC and host-link trackers — pricing happens at
    report time with the `hw_model` inter-chip constants.  Forward traffic
    is activations crossing a chip boundary as 3-bit output-ADC codes;
    backward traffic is errors returning as 8-bit sign-magnitude codes
    (the NoC's quantize-at-the-boundary rule lifted to the inter-chip
    link).  Bits are tracked per boundary so the 1F1B schedule can price
    each hop separately."""
    gbps: float = hw.INTERCHIP_GBPS
    pj_per_bit: float = hw.INTERCHIP_PJ_PER_BIT
    fwd_bits: dict = dataclasses.field(default_factory=dict)
    bwd_bits: dict = dataclasses.field(default_factory=dict)
    fwd_samples: int = 0          # samples that crossed the full boundary set
    bwd_samples: int = 0

    def record_fwd(self, boundary: int, bits_per_sample: int,
                   samples: int) -> None:
        """``samples`` activations crossed ``boundary`` as ADC codes."""
        self.fwd_bits[boundary] = (self.fwd_bits.get(boundary, 0)
                                   + bits_per_sample * samples)
        if boundary == 0:
            self.fwd_samples += samples

    def record_bwd(self, boundary: int, bits_per_sample: int,
                   samples: int) -> None:
        """``samples`` errors crossed ``boundary`` as sign-magnitude codes."""
        self.bwd_bits[boundary] = (self.bwd_bits.get(boundary, 0)
                                   + bits_per_sample * samples)
        if boundary == 0:
            self.bwd_samples += samples

    @property
    def fwd_bits_total(self) -> int:
        """All forward activation bits carried, every boundary."""
        return sum(self.fwd_bits.values())

    @property
    def bwd_bits_total(self) -> int:
        """All backward error bits carried, every boundary."""
        return sum(self.bwd_bits.values())

    def fwd_bits_per_sample(self) -> float:
        """Measured per-sample forward boundary traffic (all boundaries)."""
        return self.fwd_bits_total / max(self.fwd_samples, 1)

    def bwd_bits_per_sample(self) -> float:
        """Measured per-sample backward boundary traffic (all boundaries)."""
        return self.bwd_bits_total / max(self.bwd_samples, 1)

    def time_us(self, bits: float) -> float:
        """Transfer time of ``bits`` over one inter-chip link."""
        return bits / (self.gbps * 1e9) * 1e6

    def energy_j(self, bits: float) -> float:
        """SerDes energy of moving ``bits`` across a chip boundary."""
        return bits * self.pj_per_bit * 1e-12


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Per-sample measured costs of the virtual chip (one app)."""
    name: str
    dims: tuple[int, ...]
    cores: int                      # placed physical cores
    infer_samples: int
    train_samples: int
    infer_time_us: float            # serialized single-sample latency
    infer_energy_j: float           # core energy (no IO)
    infer_io_j: float
    train_time_us: float
    train_energy_j: float           # incl. control logic
    train_io_j: float
    beat_us: float                  # steady-state pipeline beat (Table IV)
    throughput_sps: float           # 1 sample per beat at steady state
    routed_per_sample: float
    link_utilization: float

    @property
    def infer_total_j(self) -> float:
        """Per-sample recognition energy including off-chip IO."""
        return self.infer_energy_j + self.infer_io_j

    @property
    def train_total_j(self) -> float:
        """Per-sample training energy including off-chip IO."""
        return self.train_energy_j + self.train_io_j

    # ---- cross-validation ----------------------------------------------

    def compare_hw(self, cost: hw.AppCost | None = None,
                   pretraining: bool = False) -> dict[str, float]:
        """Relative error of each measured quantity vs the analytic model.

        The acceptance contract is |err| <= 1% for train/infer time and
        energy; a violation means either the simulator executed something
        the model does not price or the model claims something the chip
        does not do."""
        if cost is None:
            cost = hw.network_cost(self.name, list(self.dims),
                                   pretraining=pretraining)
        rel = _rel
        out = {
            "infer_time": rel(self.infer_time_us, cost.infer.time_us),
            "infer_energy": rel(self.infer_energy_j, cost.infer.energy_j),
            "infer_io": rel(self.infer_io_j, cost.io_energy_infer_j),
        }
        if self.train_samples:
            out.update({
                "train_time": rel(self.train_time_us, cost.train.time_us),
                "train_energy": rel(self.train_energy_j,
                                    cost.train.energy_j),
                "train_io": rel(self.train_io_j, cost.io_energy_train_j),
            })
        return out

    def vs_gpu(self) -> dict[str, float]:
        """Energy-vs-K20 comparison from *measured* simulator counters
        (the paper's Fig. 23/25 headline, re-derived from execution)."""
        dims = list(self.dims)
        g_train = hw.gpu_cost(dims, train=True)
        g_infer = hw.gpu_cost(dims, train=False)
        out = {"stream_speedup": g_infer.time_us / self.beat_us}
        if self.infer_samples:
            out.update({
                "infer_speedup": g_infer.time_us / self.infer_time_us,
                "infer_energy_eff": g_infer.energy_j / self.infer_total_j,
            })
        if self.train_samples:
            out.update({
                "train_speedup": g_train.time_us / self.train_time_us,
                "train_energy_eff": g_train.energy_j / self.train_total_j,
            })
        return out

    def rows(self) -> list[dict]:
        """BENCH_sim.json rows (benchmarks/run.py guarded-write path)."""
        cfg = f"dims={'x'.join(map(str, self.dims))},cores={self.cores}"
        rows = [
            {"name": f"sim.{self.name}.infer", "config": cfg,
             "us_per_call": round(self.infer_time_us, 4),
             "samples_per_s": round(1e6 / self.infer_time_us, 2)
             if self.infer_time_us else 0.0,
             "joules_per_sample": self.infer_total_j,
             "derived": f"pJ/sample={self.infer_total_j * 1e12:.2f}"},
            {"name": f"sim.{self.name}.stream", "config": cfg,
             "us_per_call": round(self.beat_us, 4),
             "samples_per_s": round(self.throughput_sps, 2),
             "joules_per_sample": self.infer_total_j,
             "derived": (f"samples/s={self.throughput_sps:.0f} "
                         f"link_util={self.link_utilization:.2f}")},
        ]
        if self.train_samples:
            rows.append(
                {"name": f"sim.{self.name}.train", "config": cfg,
                 "us_per_call": round(self.train_time_us, 4),
                 "samples_per_s": round(1e6 / self.train_time_us, 2)
                 if self.train_time_us else 0.0,
                 "joules_per_sample": self.train_total_j,
                 "derived": f"pJ/sample={self.train_total_j * 1e12:.2f}"})
        return rows


@dataclasses.dataclass(frozen=True)
class FarmReport:
    """Aggregate measured costs of an N-chip farm (repro.sim.cluster).

    Built by summing the per-chip counters (``per_chip`` holds each chip's
    own SimReport) plus the farm-level host-link counters; cross-validated
    two ways (``tests/test_farm.py``): against the summed per-chip reports
    (internal consistency) and against ``hw_model.farm_cost`` (the §5.3
    contract extended to the farm)."""
    name: str
    n_chips: int
    dims: tuple[int, ...]
    per_chip: tuple[SimReport, ...]
    beat_us: float
    serve_samples: int                # retired by the serving front-end
    serve_beats: int
    serve_samples_per_s: float        # aggregate steady-state (simulated)
    serve_j_per_sample: float         # core + TSV + host-link, measured
    train_samples: int                # global samples trained
    train_steps: int
    train_step_us: float              # measured per farm step
    train_j_per_sample: float
    host_serve_bits: float            # host-link bits per served sample
    host_train_bits: float            # host-link bits per trained sample
    host_reconcile_bits: float        # per training step, all chips
    host_link_utilization: float      # serve-side: link time / beat
    host_serve_bits_total: int = 0    # raw tracker totals (all samples)
    host_train_bits_total: int = 0
    host_reconcile_bits_total: int = 0
    serve_slot_m: float = 1.0         # samples per serving slot (request
                                      # microbatch, measured)
    analytic: "object | None" = None  # farm_cost built with the farm's
                                      # actual settings (share/bits/grid)

    @property
    def cores(self) -> int:
        """Placed physical cores across the whole farm."""
        return sum(r.cores for r in self.per_chip)

    def compare_chip_sum(self) -> dict[str, float]:
        """Farm aggregates vs the summed per-chip counters.

        Two kinds of check:

        * ``*_lockstep`` — a real invariant: the farm executes replicas in
          lockstep (train) and bills served samples uniformly, so every
          chip's per-sample counters must equal chip 0's.  A per-chip
          counter that drifts (double-billed phase, missed NoC record)
          fails here.
        * ``*_energy`` — double-entry bookkeeping: the headline per-sample
          farm energies re-derived from the RAW per-chip + host-link
          totals.  This catches asymmetric edits to either side of the
          aggregation (``ChipFarm.report()`` vs this re-derivation); a
          bug shared by both formulas is caught by ``compare_hw`` instead,
          which prices the same quantities from the mapping alone.
        """
        link_j = hw.HOST_LINK_PJ_PER_BIT * 1e-12
        rel = _rel
        out = {}
        ref = self.per_chip[0]
        # per-sample quantities are only defined for chips that ran
        # samples (a short request queue can leave trailing chips idle)
        busy = [r for r in self.per_chip if r.infer_samples]
        if busy:
            out["infer_lockstep"] = max(
                max(rel(r.infer_time_us, busy[0].infer_time_us),
                    rel(r.infer_total_j, busy[0].infer_total_j))
                for r in busy)
        if self.train_samples:
            out["train_lockstep"] = max(
                max(rel(r.train_time_us, ref.train_time_us),
                    rel(r.train_total_j, ref.train_total_j),
                    rel(r.train_samples,
                        self.train_samples / self.n_chips))
                for r in self.per_chip)
        # keys are distinct from compare_hw's so merged gate dicts
        # ({**chip_sum, **hw}) never shadow either check
        if self.serve_samples:
            infer_samples = sum(r.infer_samples for r in self.per_chip)
            chip_total_j = sum(r.infer_total_j * r.infer_samples
                               for r in self.per_chip)
            per_sample = (chip_total_j / infer_samples
                          + self.host_serve_bits_total * link_j
                          / self.serve_samples)
            out["serve_energy_vs_chips"] = rel(self.serve_j_per_sample,
                                               per_sample)
        if self.train_samples:
            chip_total_j = sum(r.train_total_j * r.train_samples
                               for r in self.per_chip)
            link_total_j = (self.host_train_bits_total
                            + self.host_reconcile_bits_total) * link_j
            out["train_energy_vs_chips"] = rel(
                self.train_j_per_sample,
                (chip_total_j + link_total_j) / self.train_samples)
        return out

    def compare_hw(self, cost: "object | None" = None) -> dict[str, float]:
        """Relative error vs the analytic ``hw_model.farm_cost`` (<= 1%).

        With no explicit ``cost`` the report's own ``analytic`` cost is
        used — built by ``ChipFarm.report()`` with the farm's actual
        share_small_layers / input_bits / core-grid settings."""
        if cost is None:
            cost = self.analytic
        if cost is None:
            per_chip_batch = max(
                self.train_samples // max(self.train_steps, 1)
                // self.n_chips, 1)
            cost = hw.farm_cost(self.name, list(self.dims), self.n_chips,
                                batch_per_chip=per_chip_batch)
        rel = _rel
        out = {"beat": rel(self.beat_us, cost.beat_us)}
        if self.serve_samples:
            if self.serve_samples_per_s > 0:
                # capacity was measured over full beats; the analytic
                # side prices one request slot per chip per beat, so a
                # measured microbatch scales it
                out["serve_throughput"] = rel(
                    self.serve_samples_per_s,
                    cost.serve_samples_per_s * self.serve_slot_m)
            out["serve_energy"] = rel(self.serve_j_per_sample,
                                      cost.serve_j_per_sample)
            out["host_serve_bits"] = rel(self.host_serve_bits,
                                         cost.host_bits_infer)
        if self.train_steps:
            out["train_step_time"] = rel(self.train_step_us,
                                         cost.train_step_us)
            out["train_energy"] = rel(self.train_j_per_sample,
                                      cost.train_j_per_sample)
            out["reconcile_bits"] = rel(
                self.host_reconcile_bits / self.n_chips,
                cost.reconcile_bits)
        return out

    def rows(self) -> list[dict]:
        """BENCH_farm.json rows."""
        cfg = f"chips={self.n_chips},dims={'x'.join(map(str, self.dims))}"
        rows = []
        if self.serve_samples:
            rows.append({
                "name": f"farm.{self.name}.c{self.n_chips}.serve",
                "config": cfg,
                # samples_per_s is 0 when no beat ever filled every chip
                # slot (fewer requests than chips): no capacity measured
                "us_per_call": (round(1e6 / self.serve_samples_per_s, 4)
                                if self.serve_samples_per_s else 0.0),
                "samples_per_s": round(self.serve_samples_per_s, 2),
                "joules_per_sample": self.serve_j_per_sample,
                "derived": (f"beats={self.serve_beats} "
                            f"link_util={self.host_link_utilization:.3f}"),
            })
        if self.train_steps:
            rows.append({
                "name": f"farm.{self.name}.c{self.n_chips}.train",
                "config": cfg,
                "us_per_call": round(self.train_step_us, 4),
                "samples_per_s": round(
                    1e6 * self.train_samples
                    / max(self.train_step_us * self.train_steps, 1e-12), 2),
                "joules_per_sample": self.train_j_per_sample,
                "derived": (f"steps={self.train_steps} "
                            f"reconcile_bits={self.host_reconcile_bits:.0f}"),
            })
        return rows


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """Aggregate measured costs of a K-chip pipeline fabric
    (``repro.sim.fabric``, DESIGN.md §7).

    Built from the per-chip-slice counters (each slice's `SimReport`) plus
    the inter-chip link tracker; cross-validated against
    ``hw_model.pipeline_cost`` (the §5.3 contract extended to the
    inter-chip link) by :meth:`compare_hw`, asserted in
    ``tests/test_pipeline_fabric.py`` and enforced by
    ``python -m repro.launch.pipeline``."""
    name: str
    n_chips: int
    dims: tuple[int, ...]
    stage_groups: tuple[tuple[int, ...], ...]
    cores_per_chip: tuple[int, ...]
    per_chip: tuple[SimReport, ...]
    beat_us: float
    serve_samples: int                # retired by the serving front-end
    serve_beats: int
    serve_samples_per_s: float        # steady-state (one sample per beat)
    serve_j_per_sample: float         # core + TSV + inter-chip link
    serve_latency_us: float           # S stage hops at one beat each
    link_utilization: float           # busiest boundary: link time / beat
    train_samples: int
    train_steps: int
    train_step_us: float              # executed wave, measured
    train_j_per_sample: float
    link_bits_fwd: float              # per sample, all boundaries
    link_bits_bwd: float
    link_bits_total: int              # raw tracker total, both directions
    span_us: float                    # 1F1B schedule span (measured slices)
    bubble_fraction: float
    n_micro: int = 1
    batch_per_step: int = 1
    serve_slot_m: float = 1.0         # samples per serving slot (request
                                      # microbatch, measured)
    analytic: "object | None" = None  # pipeline_cost with matching settings

    @property
    def cores(self) -> int:
        """Placed physical cores across the whole pipeline."""
        return sum(self.cores_per_chip)

    def compare_hw(self, cost: "object | None" = None) -> dict[str, float]:
        """Relative error vs the analytic ``hw_model.pipeline_cost``
        (<= 1%).  With no explicit ``cost`` the report's own ``analytic``
        cost is used — built by ``ChipPipeline.report()`` with the
        fabric's actual split / batch / microbatch settings."""
        if cost is None:
            cost = self.analytic
        if cost is None:
            cost = hw.pipeline_cost(
                self.name, list(self.dims), n_chips=self.n_chips,
                batch=self.batch_per_step, n_micro=self.n_micro)
        rel = _rel
        out = {"beat": rel(self.beat_us, cost.beat_us)}
        if self.serve_samples:
            out.update({
                "serve_energy": rel(self.serve_j_per_sample,
                                    cost.serve_j_per_sample),
                "serve_latency": rel(self.serve_latency_us,
                                     cost.serve_latency_us),
                # the analytic side prices one request slot per beat; a
                # measured microbatch scales it (same rule as the farm)
                "serve_throughput": rel(
                    self.serve_samples_per_s,
                    cost.serve_samples_per_s * self.serve_slot_m),
                "serve_link_bits": rel(self.link_bits_fwd,
                                       cost.link_bits_fwd),
            })
        if self.train_steps:
            out.update({
                "train_step_time": rel(self.train_step_us,
                                       cost.train_step_us),
                "train_energy": rel(self.train_j_per_sample,
                                    cost.train_j_per_sample),
                "train_link_bits_fwd": rel(self.link_bits_fwd,
                                           cost.link_bits_fwd),
                "train_link_bits_bwd": rel(self.link_bits_bwd,
                                           cost.link_bits_bwd),
                "span": rel(self.span_us, cost.span_us),
            })
        return out

    def rows(self) -> list[dict]:
        """BENCH_pipeline.json rows (shared bench schema)."""
        cfg = (f"chips={self.n_chips},dims={'x'.join(map(str, self.dims))},"
               f"cores={'+'.join(map(str, self.cores_per_chip))}")
        rows = []
        if self.serve_samples:
            rows.append({
                "name": f"pipeline.{self.name}.k{self.n_chips}.serve",
                "config": cfg,
                "us_per_call": (round(1e6 / self.serve_samples_per_s, 4)
                                if self.serve_samples_per_s else 0.0),
                "samples_per_s": round(self.serve_samples_per_s, 2),
                "joules_per_sample": self.serve_j_per_sample,
                "derived": (f"beats={self.serve_beats} "
                            f"latency_us={self.serve_latency_us:.2f} "
                            f"link_util={self.link_utilization:.3f}"),
            })
        if self.train_steps:
            rows.append({
                "name": f"pipeline.{self.name}.k{self.n_chips}.train",
                "config": cfg,
                "us_per_call": round(self.train_step_us, 4),
                "samples_per_s": round(
                    1e6 * self.train_samples
                    / max(self.train_step_us * self.train_steps, 1e-12), 2),
                "joules_per_sample": self.train_j_per_sample,
                "derived": (f"steps={self.train_steps} "
                            f"span_us={self.span_us:.2f} "
                            f"bubble={self.bubble_fraction:.3f} "
                            f"n_micro={self.n_micro}"),
            })
        return rows
