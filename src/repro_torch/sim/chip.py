"""VirtualChip: execute networks on the simulated multicore grid.

Port of ``repro.sim.chip`` (its eager per-stage path).  A chip is a
`Placement` (stacked per-core conductances, one stage per layer) plus
counters; it runs:

  * ``infer``        — one wave through the stages, serialized-latency
                       semantics (the analytic model's recognition pass);
  * ``infer_stream`` — pipelined streaming (Fig. 2): steady-state
                       throughput is one sample per beat = crossbar eval +
                       one static routing slot (Table IV's 0.77 us);
  * ``train_step``   — the paper's three phases per layer (Table II):
                       fwd (record inputs + DPs), bwd (8-bit errors through
                       the same conductances), update (pulse-discretized
                       outer product written into the stacks).

Every stage executes as ONE launch of a hand-written kernel over its core
stack: the forward through `kernels/ops.crossbar_fwd_stacked` (a Fig.-14
aggregation stage is one more launch inside its layer's time slot), the
backward through `crossbar_bwd_stacked` and the update through
`pulse_update_stacked`.  `infer` equals `core.crossbar.mlp_forward`,
`train_step` equals `core.crossbar.paper_backprop_step`, and the counters
reproduce `hw_model`'s analytic time/energy to <= 1%.

Not ported yet (ROADMAP Queue 1): the compiled executor with its
``StageStacks`` envelope and CUDA-graph capture, and fault injection.

Counting conventions (shared with the analytic model):
  * an aggregation sub-stage executes inside its layer's slot; its cores
    are billed for every phase of the layer;
  * routed outputs per layer = sub-neuron partials (``row_tiles*fan_out``)
    when fan-in is split, else ``fan_out``;
  * loopback-shared layers execute their stages time-multiplexed on one
    core: placed cores shrink, per-layer execution cost does not.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import hw_model as hw
from repro_torch.core import quantization as q
from repro_torch.core.crossbar import (CORE_COLS, CORE_ROWS, CrossbarSpec,
                                       hard_sigmoid, hard_sigmoid_deriv)
from repro_torch.core.mapping import map_network
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sim.noc import NocTracker
from repro_torch.sim.placer import (Placement, Stage, place_network,
                                    stage_dot_products, tile_inputs)
from repro_torch.sim.report import PhaseCounters, SimReport


def _tile_cols(v: torch.Tensor, r: int, c: int, cols: int) -> torch.Tensor:
    """(M, fan_out) per-neuron values -> (r*c, M, cols) per-core slabs
    (slice t = i*c + j carries fan-out tile j, same for every fan-in i)."""
    M, O = v.shape
    vp = torch.nn.functional.pad(v, (0, c * cols - O))
    ct = vp.reshape(M, c, cols).transpose(0, 1)          # (c, M, cols)
    return ct.repeat(r, 1, 1)


class VirtualChip:
    """A placed network executing on the simulated core grid."""

    def __init__(self, layers: list[dict[str, torch.Tensor]],
                 spec: CrossbarSpec | None = None, *,
                 rows: int = CORE_ROWS, cols: int = CORE_COLS,
                 name: str = "app", share_small_layers: bool = False,
                 input_bits: int = 8,
                 placement: Placement | None = None,
                 faults=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if spec is None:
            from repro_torch.configs.paper_apps import PAPER_SPEC
            spec = PAPER_SPEC
        if spec.split_activation:
            raise NotImplementedError(
                "the virtual chip implements exact aggregation only "
                "(split_activation=False); see DESIGN.md 'Virtual chip'")
        if faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet: ROADMAP Queue 1 item 4")
        self.spec = spec
        self.name = name
        self.input_bits = input_bits
        if placement is None:
            layers = [{k: torch.as_tensor(v, dtype=torch.float32,
                                          device=self.device)
                       for k, v in p.items()} for p in layers]
            dims = [int(layers[0]["g_plus"].shape[0])] + \
                   [int(p["g_plus"].shape[1]) for p in layers]
            nmap = map_network(dims, rows, cols,
                               share_small_layers=share_small_layers)
            placement = place_network(layers, nmap, rows, cols)
        self.placement = placement
        self.infer_counters = PhaseCounters(
            noc=NocTracker(slot_cycles=placement.cols))
        self.train_counters = PhaseCounters(
            noc=NocTracker(slot_cycles=placement.cols))

    # ------------------------------------------------------------------
    # Stage execution (one kernel launch per stage)
    # ------------------------------------------------------------------

    def _stage_dp(self, st: Stage, h: torch.Tensor) -> torch.Tensor:
        """Run one stage's core stack on a (M, fan_in) input wave; returns
        the exact-aggregated (M, fan_out) dot products."""
        return stage_dot_products(st, h, st.g_plus, st.g_minus,
                                  kernel_ops.crossbar_fwd_stacked)

    def _count_stage(self, counters: PhaseCounters, st: Stage,
                     samples: int) -> None:
        """Measured fwd accounting for one stage execution: one time slot
        on the stacks' core count, plus the stage's NoC egress."""
        counters.record_phase("fwd", st.n_cores, samples)
        links = st.g_plus.shape[0]           # one outbound link per core
        counters.noc.record(st.index, st.lmap.routed_outputs, links,
                            samples)

    def _forward(self, x: torch.Tensor, counters: PhaseCounters | None, *,
                 quantize_tail: bool = False
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor],
                            torch.Tensor]:
        """Wave through all stages; returns (per-stage inputs, DPs, output
        activation): the network input is DAC-driven (no ADC), inter-stage
        activations are 3-bit quantized, and the last stage's output leaves
        raw — unless ``quantize_tail``, when it is ADC-quantized too (a
        mid-pipeline slice whose output crosses an inter-chip link)."""
        acts, dps = [], []
        h = x
        last = len(self.placement.stages) - 1
        for si, st in enumerate(self.placement.stages):
            acts.append(h)
            dp = self._stage_dp(st, h)
            dps.append(dp)
            if counters is not None:
                self._count_stage(counters, st, x.shape[0])
            h = hard_sigmoid(dp)
            if (si < last or quantize_tail) and self.spec.transport_quant:
                h = q.adc_quantize_ste(h, self.spec.adc_bits)
        return acts, dps, h

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return torch.atleast_2d(x)

    def forward_wave(self, x, *, count: bool = True, train: bool = False,
                     quantize_tail: bool = False
                     ) -> tuple[list[torch.Tensor], list[torch.Tensor],
                                torch.Tensor]:
        """Public wave execution over this chip's stage slice.

        Returns ``(acts, dps, out)``: per-stage input activations, per-stage
        dot products, and the output activation as it leaves the chip —
        tail-quantized when ``quantize_tail``.  ``train=True`` bills the
        training counters instead of the inference counters."""
        x = self._input(x)
        counters = None
        if count:
            counters = self.train_counters if train else self.infer_counters
        return self._forward(x, counters, quantize_tail=quantize_tail)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def infer(self, x, *, count: bool = True) -> torch.Tensor:
        """One recognition wave (serialized-latency semantics)."""
        x = self._input(x)
        counters = self.infer_counters if count else None
        _, dps, _ = self._forward(x, counters)
        out = hard_sigmoid(dps[-1])
        if count:
            M = x.shape[0]
            self.infer_counters.samples += M
            self.infer_counters.record_io(
                self.placement.dims[0] * self.input_bits
                + self.placement.dims[-1] * hw.ADC_BITS_OUT, M)
        return out

    def infer_stream(self, x) -> tuple[torch.Tensor, dict]:
        """Pipelined streaming recognition (Fig. 2): sample ``m`` enters
        stage 0 at beat ``m`` while sample ``m-1`` occupies stage 1 — at
        steady state every stage is busy and one sample retires per beat.

        Stages are sample-independent, so the wave execution computes the
        identical numbers; what changes is the *time* model, derived from
        measured NoC slot counters."""
        x = self._input(x)
        out = self.infer(x)
        S = len(self.placement.stages)
        M = x.shape[0]
        beats = S + M - 1
        stats = {
            "beat_us": self.beat_us,
            "latency_us": S * self.beat_us,
            "makespan_us": beats * self.beat_us,
            "throughput_sps": 1e6 / self.beat_us,
            "occupancy": S * M / (S * beats),
        }
        return out, stats

    @property
    def beat_us(self) -> float:
        """Steady-state pipeline beat: one crossbar evaluation slot plus
        one static routing slot (Table IV: 0.27 + 100 cycles @ 200 MHz
        = 0.77 us for the paper geometry)."""
        return hw.FWD_US + self.infer_counters.noc.slot_us

    # ------------------------------------------------------------------
    # Training (the paper's fwd / bwd / update phases, Table II)
    # ------------------------------------------------------------------

    def backward_update(self, acts: list[torch.Tensor],
                        dps: list[torch.Tensor], delta: torch.Tensor,
                        lr: float, *, global_batch: int | None = None,
                        counters: PhaseCounters | None = None
                        ) -> torch.Tensor:
        """Run the bwd + update phases over this chip's stage slice.

        ``delta`` is the error arriving at the slice's OUTPUT side (the
        global ``target - out`` for a whole chip); each stage first
        quantizes it to 8-bit sign-magnitude (III.F step 1).  Returns the
        error that leaves the first stage toward the network input.
        ``global_batch`` is the learning-rate batch normalizer (defaults to
        ``delta``'s batch).  Each stage's backward phase is one
        ``crossbar_bwd_stacked`` launch and its update phase one
        ``pulse_update_stacked`` launch; the new conductances are stored
        with `Placement.set_stage_stacks`."""
        spec = self.spec
        M = delta.shape[0]
        B = M if global_batch is None else global_batch
        c = counters if counters is not None else self.train_counters

        for si in reversed(range(len(self.placement.stages))):
            st = self.placement.stages[si]
            r, ct = st.row_tiles, st.col_tiles
            if spec.error_quant:
                # III.F step 1: errors ride the links as 8-bit
                # sign-magnitude codes.
                delta = q.error_quantize(delta, spec.err_bits).dequantize()
            local = delta * hard_sigmoid_deriv(dps[si])

            # -- backward phase: the error drives the SAME conductance
            # stacks transposed (Eq. 7 / Fig. 9), one launch.
            ds = _tile_cols(local, r, ct, st.cols)
            dxs = kernel_ops.crossbar_bwd_stacked(ds, st.g_plus, st.g_minus)
            dx = (dxs.reshape(r, ct, M, st.rows).sum(dim=1)
                     .transpose(0, 1).reshape(M, r * st.rows))
            delta_prev = dx[:, 1:st.lmap.fan_in + 1]   # strip bias line
            c.record_phase("bwd", st.n_cores, M)

            # -- update phase: per-core outer product + pulse
            # discretization + clipping, one launch.
            xs = tile_inputs(acts[si], r, ct, st.rows)
            if spec.update_quant:
                gp, gm = kernel_ops.pulse_update_stacked(
                    st.g_plus, st.g_minus, xs, ds, lr=lr / B,
                    max_dw=spec.max_update, levels=spec.update_levels,
                    w_max=spec.w_max)
            else:
                dw = 2.0 * (lr / B) * torch.einsum("tmk,tmn->tkn", xs, ds)
                gp = torch.clamp(st.g_plus + 0.5 * dw, 0.0, spec.w_max)
                gm = torch.clamp(st.g_minus - 0.5 * dw, 0.0, spec.w_max)
            self.placement.set_stage_stacks(si, gp, gm)
            c.record_phase("update", st.n_cores, M)

            delta = delta_prev
        return delta

    def train_step(self, x, target, lr: float) -> torch.Tensor:
        """One stochastic-BP step executed on the chip, writing the pulse
        updates into the conductance stacks.  Matches
        `core.crossbar.paper_backprop_step` under equal specs (up to pulse
        counts that sit on a rounding boundary).  Returns the output error
        (target - prediction)."""
        x = self._input(x)
        target = self._input(target)
        M = x.shape[0]
        c = self.train_counters
        acts, dps, _ = self._forward(x, c)
        out = hard_sigmoid(dps[-1])
        self.backward_update(acts, dps, target - out, lr, counters=c)

        c.samples += M
        c.record_io(2 * self.placement.dims[0] * self.input_bits
                    + self.placement.dims[-1] * hw.ADC_BITS_OUT, M)
        return target - out

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------

    def layers(self) -> list[dict[str, torch.Tensor]]:
        """Current conductances as per-layer dicts."""
        return self.placement.extract_params()

    def report(self) -> SimReport:
        """Measured per-sample costs from this chip's counters (the
        quantities `hw_model.network_cost` cross-validates, §5.3)."""
        inf, tr = self.infer_counters, self.train_counters
        return SimReport(
            name=self.name,
            dims=self.placement.dims,
            cores=self.placement.n_cores,
            infer_samples=inf.samples,
            train_samples=tr.samples,
            infer_time_us=inf.time_us() if inf.samples else 0.0,
            infer_energy_j=inf.core_energy_j() if inf.samples else 0.0,
            infer_io_j=inf.io_energy_j() if inf.samples else 0.0,
            train_time_us=tr.time_us() if tr.samples else 0.0,
            train_energy_j=(tr.core_energy_j(include_ctrl=True)
                            if tr.samples else 0.0),
            train_io_j=tr.io_energy_j() if tr.samples else 0.0,
            beat_us=self.beat_us,
            throughput_sps=1e6 / self.beat_us,
            routed_per_sample=(
                inf.noc.routed_outputs_per_sample(inf.samples)
                if inf.samples
                else tr.noc.routed_outputs_per_sample(tr.samples)),
            link_utilization=(inf.noc.link_utilization if inf.samples
                              else tr.noc.link_utilization),
        )
