"""Pipeline-parallel chip fabric: one network split ACROSS chips (port of
``repro.sim.fabric``).

The farm (`repro_torch.sim.cluster`) replicates whole chips
data-parallel, so a network whose placed core count exceeds one chip's
budget cannot run at all.  This module is the other scaling axis
(DESIGN.md §7): the mapper's stage list is partitioned into contiguous
per-chip groups (`core.mapping.split_network`), each group executes on its
own virtual chip exactly as before, and the two values that cross a chip
boundary obey the NoC's quantize-at-the-boundary rule, lifted to a
modeled inter-chip link:

  * forward: the boundary activation crosses as 3-bit output-ADC codes —
    the serial chip quantizes between stages anyway, so the split is
    *bitwise invisible* to the numerics;
  * backward: the error returns as 8-bit sign-magnitude codes — the
    serial training loop quantizes the error at the top of every stage
    iteration (III.F step 1), so again the boundary adds no new operation,
    only a place to *meter* it.

Consequently `ChipPipeline.train_step` equals the serial
`VirtualChip.train_step` on the unsplit network bit for bit: every stage
launches on its own cores whatever envelope holds it (the compiled
executor's envelope invariance), and the slices normalise the learning
rate by the whole step's batch as the serial chip does.  What the fabric
adds is structure and accounting:

  * `ChipPipeline` — K chip slices (`VirtualChip`s on `sub_placement`s
    that alias the full placement's `Stage` objects) executing the wave
    fwd / bwd / update phases in pipeline order, with per-slice
    `PhaseCounters` and an `InterChipLinkTracker` metering every boundary
    crossing.  Compiled (the default), each slice runs its wave and its
    backward/update phases as one captured CUDA graph each
    (`sim.compiled.chip_forward`, `chip_backward`); ``compiled=False``
    is the eager per-stage path;
  * a 1F1B *time* model — the executed numerics are the full-batch wave
    (the paper's training unit applies pulse updates once per batch, so
    microbatch staggering cannot change the update); the ``n_micro`` 1F1B
    schedule is priced by `hw_model.schedule_1f1b` from the measured slice
    times and cross-validated against `hw_model.pipeline_cost`;
  * `PipelineServer` — drains a `runtime.serve_loop.RequestQueue` through
    the chip pipeline at one beat per stage hop: eager, per beat each chip
    runs ONE stacked forward launch over its slice (idle slots drive
    zeros) plus one aggregation launch when its slice has fan-in-split
    stages; compiled, the whole session is the single-lane case of the
    farm's captured serving beat (`sim.compiled.run_serve_session`), one
    forward launch a beat.  One sample retires per beat at steady state —
    the Table IV beat survives the split;
  * `PipelineFarm` — N lockstep replicas of a K-chip pipeline ("farm of
    pipelines").  The replica axis delegates to `ChipFarm`, the pipeline
    axis adds the per-replica boundary metering.  The reference's device
    mesh (``mesh=``) waits for a multi-GPU host.

All measured quantities cross-validate against ``hw_model.pipeline_cost``
to <= 1%, enforced by ``python -m repro_torch.launch.pipeline``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import hw_model as hw
from repro_torch.core import quantization as q
from repro_torch.core.crossbar import (CORE_COLS, CORE_ROWS, CrossbarSpec,
                                       hard_sigmoid)
from repro_torch.core.mapping import map_network, split_network
from repro_torch.kernels import ops as kernel_ops
from repro_torch.runtime.serve_loop import RequestQueue
from repro_torch.sim import compiled as csim
from repro_torch.sim.chip import VirtualChip
from repro_torch.sim.placer import (Placement, StageStacks,
                                    build_stage_stacks,
                                    fold_subneuron_partials, place_network,
                                    stage_dp_from_outputs, sub_placement,
                                    tile_inputs)
from repro_torch.sim.report import InterChipLinkTracker, PipelineReport


class ChipPipeline:
    """A network pipeline-split over K virtual chips (DESIGN.md §7)."""

    def __init__(self, layers: list[dict[str, torch.Tensor]],
                 spec: CrossbarSpec | None = None, *,
                 max_cores_per_chip: int | None = None,
                 n_chips: int | None = None,
                 rows: int = CORE_ROWS, cols: int = CORE_COLS,
                 name: str = "pipeline", share_small_layers: bool = False,
                 input_bits: int = 8, device: str | torch.device = "cuda",
                 compiled: bool = True):
        self.device = resolve_device(device)
        self.compiled = compiled
        if spec is None:
            from repro_torch.configs.paper_apps import PAPER_SPEC
            spec = PAPER_SPEC
        if spec.split_activation:
            raise NotImplementedError(
                "the pipeline fabric inherits the virtual chip's "
                "exact-aggregation restriction (split_activation=False)")
        self.spec = spec
        self.name = name
        self.input_bits = input_bits
        self.share_small_layers = share_small_layers
        if max_cores_per_chip is None and n_chips is None:
            # default chip budget: the paper's 144-core system (Sec. VI)
            max_cores_per_chip = hw.SYSTEM_CORES
        self._split_kw = dict(max_cores_per_chip=max_cores_per_chip,
                              n_chips=n_chips)
        layers = [{k: torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
                   for k, v in p.items()} for p in layers]
        dims = [int(layers[0]["g_plus"].shape[0])] + \
               [int(p["g_plus"].shape[1]) for p in layers]
        nmap = map_network(dims, rows, cols,
                           share_small_layers=share_small_layers)
        self.placement: Placement = place_network(layers, nmap, rows, cols)
        self.groups = split_network(nmap, **self._split_kw)
        self.n_chips = len(self.groups)
        self.chips = [
            VirtualChip([], spec, name=f"{name}.pp{k}",
                        input_bits=input_bits,
                        placement=sub_placement(self.placement, g),
                        device=self.device, compiled=compiled)
            for k, g in enumerate(self.groups)]
        # boundary k sits between chips k and k+1; its width is the
        # activation dimension leaving chip k's last stage
        self.boundary_dims = tuple(dims[g[-1] + 1] for g in self.groups[:-1])
        self.link = InterChipLinkTracker()
        self.version = 0              # bumped on every conductance write
        self.serve_beats = 0
        self.serve_samples = 0
        self.serve_full_beats = 0     # beats that retired a request
        self.serve_slot_m = 1.0       # request microbatch (measured)
        self.train_steps = 0
        self.train_samples = 0
        self.batch_per_step = 1
        self.n_micro = 1
        self._serve_stacks: StageStacks | None = None
        self._seen_version = self.placement.version

    def _sync_slices(self) -> None:
        """Make the slices rebuild their envelopes when the full placement
        was written outside the pipeline (a chip built on
        ``pipe.placement``): the slices' sub-placements alias its `Stage`
        objects but keep versions of their own."""
        if self.placement.version != self._seen_version:
            for chip in self.chips:
                chip.placement.version += 1
            self._seen_version = self.placement.version

    def _get_serve_stacks(self) -> StageStacks:
        """Padded full-placement stacks for the compiled serving session —
        rebuilt when the conductances moved (the full placement's
        ``version``, which every train step bumps; the chip slices alias
        its `Stage` objects, so a rebuild always sees their latest
        writes).  The session's programs live on these stacks."""
        if (self._serve_stacks is None or self._serve_stacks.built_version
                != self.placement.version):
            self._serve_stacks = build_stage_stacks(self.placement)
        return self._serve_stacks

    def _input(self, x) -> torch.Tensor:
        return torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32,
                                                device=self.device))

    # ------------------------------------------------------------------
    # Wave execution (numerics identical to the serial chip)
    # ------------------------------------------------------------------

    def infer(self, x, *, count: bool = True) -> torch.Tensor:
        """One recognition wave through the chip pipeline.  Equals the
        serial `VirtualChip.infer` on the unsplit network bit for bit:
        the boundary ADC is the same 3-bit quantization the serial chip
        applies between stages."""
        self._sync_slices()
        h = self._input(x)
        M = h.shape[0]
        last = self.n_chips - 1
        for k, chip in enumerate(self.chips):
            _, _, h = chip.forward_wave(h, count=count,
                                        quantize_tail=k < last)
            if count:
                chip.infer_counters.samples += M
                if k < last:
                    self.link.record_fwd(
                        k, self.boundary_dims[k] * hw.ADC_BITS_OUT, M)
        if count:
            self.chips[0].infer_counters.record_io(
                self.placement.dims[0] * self.input_bits, M)
            self.chips[-1].infer_counters.record_io(
                self.placement.dims[-1] * hw.ADC_BITS_OUT, M)
        return h

    def train_step(self, x, target, lr: float, *,
                   n_micro: int = 1) -> torch.Tensor:
        """One stochastic-BP step across the chip pipeline, bit for bit
        the serial `VirtualChip.train_step` on the unsplit network.

        The executed numerics are the full-batch wave: fwd chip 0 -> K-1
        (activations crossing each boundary as ADC codes), then bwd +
        update chip K-1 -> 0 (errors crossing back as 8-bit codes, pulse
        updates written in place per stage, the learning rate normalised
        by the whole batch ``M`` as on the serial chip).  ``n_micro``
        selects the 1F1B *time* model for the step (span / bubble in the
        report); it cannot change the numerics because the pulse update
        applies once per batch with a shared error full-scale."""
        x = self._input(x)
        target = self._input(target)
        M = x.shape[0]
        if M % n_micro:
            raise ValueError(f"batch {M} not divisible by n_micro {n_micro}")
        self._sync_slices()
        last = self.n_chips - 1

        h = x
        waves = []
        for k, chip in enumerate(self.chips):
            acts, dps, h = chip.forward_wave(h, train=True,
                                             quantize_tail=k < last)
            waves.append((acts, dps))
            chip.train_counters.samples += M
            if k < last:
                self.link.record_fwd(
                    k, self.boundary_dims[k] * hw.ADC_BITS_OUT, M)
        err = target - h
        delta = err
        for k in reversed(range(self.n_chips)):
            acts, dps = waves[k]
            delta = self.chips[k].backward_update(acts, dps, delta, lr,
                                                  global_batch=M)
            if k > 0:
                self.link.record_bwd(
                    k - 1, self.boundary_dims[k - 1] * hw.ERR_BITS_LINK, M)

        self.chips[0].train_counters.record_io(
            2 * self.placement.dims[0] * self.input_bits, M)
        self.chips[-1].train_counters.record_io(
            self.placement.dims[-1] * hw.ADC_BITS_OUT, M)
        self.train_steps += 1
        self.train_samples += M
        self.batch_per_step = M
        self.n_micro = n_micro
        # the slices wrote the shared stages: whatever is keyed on the
        # full placement (serving stacks, a chip built on it) must see it
        self.version += 1
        self.placement.version += 1
        self._seen_version = self.placement.version
        return err

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def serve(self, x) -> tuple[torch.Tensor, dict]:
        """Serve a batch of requests (one per row) through the pipelined
        fabric; returns (outputs in request order, serving stats)."""
        x = self._input(x)
        if x.shape[0] == 0:
            return (torch.zeros((0, self.placement.dims[-1]),
                                device=self.device),
                    {"beats": 0, "retired": 0, "beat_us": self.beat_us,
                     "makespan_us": 0.0, "samples_per_s": 0.0,
                     "latency_us": self.serve_latency_us})
        server = PipelineServer(self)
        queue = RequestQueue(list(x))
        stats = server.run(queue)
        out = torch.stack([r.reshape(-1) for r in queue.results()])
        return out, stats

    # ------------------------------------------------------------------
    # Introspection / reporting
    # ------------------------------------------------------------------

    @property
    def beat_us(self) -> float:
        """Steady-state pipeline beat — unchanged by the chip split (a
        boundary hop rides inside the static routing slot)."""
        return hw.pipeline_beat_us(self.placement.cols)

    @property
    def serve_latency_us(self) -> float:
        """Serving latency: one beat per stage hop through the fabric."""
        return len(self.placement.stages) * self.beat_us

    def layers(self) -> list[dict[str, torch.Tensor]]:
        """Current conductances as per-layer dicts — the chip slices alias
        the full placement's stages, so this sees every chip's updates."""
        return self.placement.extract_params()

    def report(self) -> PipelineReport:
        """Aggregate the per-slice counters + link tracker into a
        `PipelineReport`, carrying the matching analytic
        `hw_model.pipeline_cost` for cross-validation."""
        per_chip = tuple(c.report() for c in self.chips)
        beat = self.beat_us
        link = self.link
        fwd_bps = link.fwd_bits_per_sample()
        bwd_bps = link.bwd_bits_per_sample()

        # serving: capacity is measured over beats that retired a request
        # only — fill/drain beats are a measurement artifact of short
        # sessions, not reduced fabric capacity (same rule as the farm)
        serve_sps = (self.serve_samples / (self.serve_full_beats * beat)
                     * 1e6 if self.serve_full_beats else 0.0)
        infer_samples = max((r.infer_samples for r in per_chip), default=0)
        serve_j = (sum(r.infer_total_j for r in per_chip)
                   + link.energy_j(fwd_bps)) if infer_samples else 0.0
        link_util = max(
            (link.time_us(link.fwd_bits[b] / max(link.fwd_samples, 1))
             / beat for b in link.fwd_bits), default=0.0)

        # training: the executed wave, per-slice counters partitioning the
        # serial chip's counters exactly
        if self.train_steps:
            counters = [c.train_counters for c in self.chips]
            t_slices = [c.time_us() for c in counters]
            B = self.batch_per_step
            step_bits = B * (fwd_bps + bwd_bps)
            train_step_us = B * sum(t_slices) + link.time_us(step_bits)
            # control logic burns on every placed core for the whole step
            # (the serial convention — the slices hold one shared step)
            total_fwd_cores = sum(c.core_steps["fwd"] / max(c.samples, 1)
                                  for c in counters)
            train_core_j = sum(c.core_energy_j(include_ctrl=False)
                               for c in counters) \
                + hw.core_step_energy_j(sum(t_slices), hw.CTRL_MW,
                                        total_fwd_cores)
            train_j = train_core_j \
                + sum(c.io_energy_j() for c in counters) \
                + link.energy_j(fwd_bps + bwd_bps)
            # 1F1B schedule from the measured slice times
            u = B // self.n_micro
            fwd_us = [u * (c.slots["fwd"] / max(c.samples, 1) * hw.FWD_US
                           + c.route_us()) for c in counters]
            bwd_us = [u * (c.slots["bwd"] / max(c.samples, 1) * hw.BWD_US
                           + c.slots["update"] / max(c.samples, 1)
                           * hw.UPD_US) for c in counters]
            n_samples = max(link.fwd_samples, 1)
            link_f = [u * link.time_us(link.fwd_bits.get(b, 0) / n_samples)
                      for b in range(self.n_chips - 1)]
            link_b = [u * link.time_us(link.bwd_bits.get(b, 0)
                                       / max(link.bwd_samples, 1))
                      for b in range(self.n_chips - 1)]
            span = hw.schedule_1f1b(fwd_us, bwd_us, link_f, link_b,
                                    self.n_micro)
            # per-chip busy time over the step = n_micro microbatch slices
            busy = self.n_micro * sum(f + b for f, b in zip(fwd_us, bwd_us))
            bubble = 1.0 - busy / (self.n_chips * span) if span else 0.0
        else:
            train_step_us = train_j = span = 0.0
            bubble = 0.0

        analytic = hw.pipeline_cost(
            self.name, list(self.placement.dims),
            batch=self.batch_per_step, n_micro=self.n_micro,
            input_bits=self.input_bits,
            share_small_layers=self.share_small_layers,
            rows=self.placement.rows, cols=self.placement.cols,
            **self._split_kw)
        return PipelineReport(
            name=self.name, n_chips=self.n_chips,
            dims=self.placement.dims, stage_groups=self.groups,
            cores_per_chip=tuple(c.placement.n_cores for c in self.chips),
            per_chip=per_chip, beat_us=beat,
            serve_samples=self.serve_samples, serve_beats=self.serve_beats,
            serve_samples_per_s=serve_sps, serve_j_per_sample=serve_j,
            serve_latency_us=self.serve_latency_us,
            link_utilization=link_util,
            train_samples=self.train_samples, train_steps=self.train_steps,
            train_step_us=train_step_us, train_j_per_sample=train_j,
            link_bits_fwd=fwd_bps, link_bits_bwd=bwd_bps,
            link_bits_total=link.fwd_bits_total + link.bwd_bits_total,
            span_us=span, bubble_fraction=bubble,
            n_micro=self.n_micro, batch_per_step=self.batch_per_step,
            serve_slot_m=self.serve_slot_m, analytic=analytic)


def build_pipeline(app: str, *, max_cores_per_chip: int | None = None,
                   n_chips: int | None = None, seed: int = 0,
                   share_small_layers: bool = False, spec=None,
                   device: str | torch.device = "cuda",
                   compiled: bool = True) -> ChipPipeline:
    """A pipeline fabric executing one paper application, its conductances
    drawn from ``seed`` on the CPU (as `launch.chipsim`'s ``build_chip``
    and `sim.cluster.build_farm` draw them), so every device gets the same
    weights."""
    from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
    from repro_torch.core import crossbar as xb
    spec = PAPER_SPEC if spec is None else spec
    device = resolve_device(device)
    dims = NETWORKS[app]
    gen = torch.Generator().manual_seed(seed)
    layers = [xb.init_conductances(f, o, spec, generator=gen, device=device)
              for f, o in zip(dims, dims[1:])]
    return ChipPipeline(layers, spec, max_cores_per_chip=max_cores_per_chip,
                        n_chips=n_chips, name=app,
                        share_small_layers=share_small_layers,
                        device=device, compiled=compiled)


class PipelineServer:
    """Pipelined serving front-end over the chip fabric.

    Wavefront execution at one beat per stage hop: a request occupies one
    global stage per beat; per beat each chip assembles the input slab of
    its OWN stage slice (idle slots drive zeros, their outputs discarded
    and unbilled) and runs ONE stacked forward launch (plus one
    aggregation launch when its slice has fan-in-split stages).  A sample
    crossing a chip boundary is metered on the inter-chip link; the hop
    rides inside the beat's static routing slot, so the Table IV beat —
    and therefore the one-sample-per-beat steady state — survives the
    split.  Stages are sample-independent, so served outputs equal the
    wave path (and `mlp_forward` up to summation order).  On a compiled
    pipeline, a fresh server draining a uniform-shape queue runs the
    whole session as one captured beat replayed per beat
    (`compiled.run_serve_session`), on a snapshot of the stacks."""

    def __init__(self, pipe: ChipPipeline):
        self.pipe = pipe
        self._version = pipe.version     # conductance snapshot guard
        self.stages = pipe.placement.stages
        self.S = len(self.stages)
        # global stage index -> owning chip
        self.owner = [k for k, g in enumerate(pipe.groups) for _ in g]
        # per-chip concatenated core stacks (a snapshot: torch.cat copies)
        self._off: list[dict[int, int]] = []
        self._stack_p, self._stack_m = [], []
        self._agg: list[dict] = []
        for g in pipe.groups:
            offs, off = {}, 0
            for s in g:
                offs[s] = off
                off += self.stages[s].g_plus.shape[0]
            self._off.append(offs)
            self._stack_p.append(torch.cat([self.stages[s].g_plus
                                            for s in g]))
            self._stack_m.append(torch.cat([self.stages[s].g_minus
                                            for s in g]))
            agg_idx = [s for s in g if self.stages[s].row_tiles > 1]
            agg = {"idx": agg_idx}
            if agg_idx:
                agg["rows"] = max(self.stages[s].agg_plus.shape[1]
                                  for s in agg_idx)
                agg["off"], ap, am = {}, [], []
                aoff = 0
                for s in agg_idx:
                    st = self.stages[s]
                    agg["off"][s] = aoff
                    aoff += st.agg_plus.shape[0]
                    pad = agg["rows"] - st.agg_plus.shape[1]
                    ap.append(torch.nn.functional.pad(st.agg_plus,
                                                      (0, 0, 0, pad)))
                    am.append(torch.nn.functional.pad(st.agg_minus,
                                                      (0, 0, 0, pad)))
                agg["p"] = torch.cat(ap)
                agg["m"] = torch.cat(am)
            self._agg.append(agg)
        self.slots: list = [None] * self.S     # (rid, input activation)
        self._slot_m: int | None = None

    def _check_snapshot(self) -> None:
        if self.pipe.version != self._version:
            raise RuntimeError(
                "pipeline conductances changed since this PipelineServer "
                "was built (a train_step ran); construct a fresh server — "
                "the serving stacks are a snapshot")

    def step(self, queue: RequestQueue) -> int:
        """Advance the fabric one beat; returns samples retired."""
        pipe = self.pipe
        self._check_snapshot()
        spec = pipe.spec
        if self.slots[0] is None:
            req = queue.pop()
            if req is not None:
                x = pipe._input(req.x)
                # the beat slab needs one static shape: all requests of a
                # serving session must share their microbatch
                if self._slot_m is None:
                    self._slot_m = x.shape[0]
                elif x.shape[0] != self._slot_m:
                    raise ValueError(
                        f"request {req.rid} has microbatch {x.shape[0]}, "
                        f"session uses {self._slot_m}; serve uniform "
                        f"request shapes")
                self.slots[0] = (req.rid, x)
        m = next((slot[1].shape[0] for slot in self.slots
                  if slot is not None), None)
        if m is None:
            return 0

        # one stacked launch per chip over its stage slice (+ one
        # aggregation launch when the slice has fan-in-split stages)
        dp_by_stage: dict[int, torch.Tensor] = {}
        for k, g in enumerate(pipe.groups):
            if not any(self.slots[s] is not None for s in g):
                continue
            parts = []
            for s in g:
                st = self.stages[s]
                if self.slots[s] is not None:
                    parts.append(tile_inputs(self.slots[s][1], st.row_tiles,
                                             st.col_tiles, st.rows))
                else:
                    parts.append(torch.zeros((st.g_plus.shape[0], m,
                                              st.rows), device=pipe.device))
            ys = kernel_ops.crossbar_fwd_stacked(torch.cat(parts),
                                                 self._stack_p[k],
                                                 self._stack_m[k])
            agg = self._agg[k]
            agg_out = None
            if agg["idx"]:
                aparts = []
                for s in agg["idx"]:
                    st = self.stages[s]
                    o = self._off[k][s]
                    u = fold_subneuron_partials(
                        ys[None, o:o + st.row_tiles * st.col_tiles], st)[0]
                    aparts.append(torch.nn.functional.pad(
                        u, (0, agg["rows"] - u.shape[-1])))
                agg_out = kernel_ops.crossbar_fwd_stacked(
                    torch.cat(aparts), agg["p"], agg["m"])
            for s in g:
                if self.slots[s] is None:
                    continue
                st = self.stages[s]
                o = self._off[k][s]
                agg_slice = None
                if st.row_tiles > 1:
                    ao = agg["off"][s]
                    agg_slice = agg_out[None, ao:ao + st.col_tiles]
                dp_by_stage[s] = stage_dp_from_outputs(
                    ys[None, o:o + st.row_tiles * st.col_tiles], st,
                    agg_slice)[0]

        # advance the wavefront, metering boundary hops
        new_slots: list = [None] * self.S
        retired = retired_requests = 0
        for s, st in enumerate(self.stages):
            if self.slots[s] is None:
                continue
            rid, _ = self.slots[s]
            k = self.owner[s]
            chip = pipe.chips[k]
            chip._count_stage(chip.infer_counters, st, m)
            h = hard_sigmoid(dp_by_stage[s])
            if s < self.S - 1:
                if spec.transport_quant:     # the hard ADC, as the program
                    h = q.adc_quantize(h, spec.adc_bits)
                if self.owner[s + 1] != k:
                    pipe.link.record_fwd(
                        k, pipe.boundary_dims[k] * hw.ADC_BITS_OUT, m)
                new_slots[s + 1] = (rid, h)
            else:
                queue.complete(rid, h)
                retired += m
                retired_requests += 1
                pipe.chips[0].infer_counters.record_io(
                    pipe.placement.dims[0] * pipe.input_bits, m)
                chip.infer_counters.record_io(
                    pipe.placement.dims[-1] * hw.ADC_BITS_OUT, m)
                for c in pipe.chips:
                    c.infer_counters.samples += m
        if retired_requests:
            pipe.serve_full_beats += 1
        self.slots = new_slots
        pipe.serve_beats += 1
        pipe.serve_samples += retired
        return retired

    def _stats(self, beats: int, retired: int, requests: int,
               steady: int) -> dict:
        """Serving stats of a session (eager and compiled alike)."""
        beat_us = self.pipe.beat_us
        return {
            "beats": beats,
            "retired": retired,
            "beat_us": beat_us,
            "makespan_us": beats * beat_us,
            "latency_us": self.pipe.serve_latency_us,
            "samples_per_s": retired / (steady * beat_us) * 1e6,
            # fraction of stage slots occupied over the session
            "occupancy": requests * self.S / max(self.S * beats, 1),
        }

    def _run_compiled(self, queue: RequestQueue) -> dict:
        """The serving session as ONE compiled beat program: the fabric is
        the single-lane (``n_lanes = 1``) case of the farm's captured beat
        over the FULL placement's stage cores — per-stage numerics are
        per-core independent, so one launch over every stage equals the
        eager per-chip launches.  The boundary quantize rule is the beat's
        ordinary inter-stage ADC; boundary link metering and the counters
        replay the static owner map host-side."""
        pipe = self.pipe
        self._check_snapshot()
        S = self.S
        st = pipe._get_serve_stacks()
        gp_cat = torch.cat([st.g_plus[s, :m.T]
                            for s, m in enumerate(st.stage_maps)])[None]
        gm_cat = torch.cat([st.g_minus[s, :m.T]
                            for s, m in enumerate(st.stage_maps)])[None]
        Q, m, _, n_beats = csim.run_serve_session(
            queue, st, gp_cat, gm_cat, pipe.spec, 1)
        self._slot_m = m

        # counters: the eager loop's per-beat billing aggregated over the
        # static schedule (every request visits every stage once)
        n = Q * m
        for s, stg in enumerate(self.stages):
            cc = pipe.chips[self.owner[s]].infer_counters
            cc.record_phase("fwd", stg.n_cores, n)
            cc.noc.record(stg.index, stg.lmap.routed_outputs,
                          stg.g_plus.shape[0], n)
        for s in range(S - 1):
            k = self.owner[s]
            if self.owner[s + 1] != k:
                pipe.link.record_fwd(
                    k, pipe.boundary_dims[k] * hw.ADC_BITS_OUT, n)
        pipe.chips[0].infer_counters.record_io(
            pipe.placement.dims[0] * pipe.input_bits, n)
        pipe.chips[self.owner[S - 1]].infer_counters.record_io(
            pipe.placement.dims[-1] * hw.ADC_BITS_OUT, n)
        for c in pipe.chips:
            c.infer_counters.samples += n
        pipe.serve_full_beats += Q
        pipe.serve_beats += n_beats
        pipe.serve_samples += n
        pipe.serve_slot_m = m
        return self._stats(n_beats, n, Q, Q)

    def run(self, queue: RequestQueue, *, max_beats: int | None = None
            ) -> dict:
        """Drain the queue; returns serving stats.

        On a compiled pipeline, a fresh server draining a uniform-shape
        queue runs the whole session as one compiled beat program;
        step-wise use (partially drained pipes, beat limits, ragged
        shapes) stays on the eager per-beat path."""
        if (self.pipe.compiled and max_beats is None
                and csim.serve_session_applicable(
                    queue, all(s is None for s in self.slots),
                    self._slot_m)):
            return self._run_compiled(queue)
        beats = retired = 0
        limit = max_beats if max_beats is not None else 10_000_000
        done_before = queue.completed
        while not queue.drained and beats < limit:
            retired += self.step(queue)
            beats += 1
        if self._slot_m is not None:
            self.pipe.serve_slot_m = self._slot_m
        return self._stats(beats, retired, queue.completed - done_before,
                           max(beats - (self.S - 1), 1))


class PipelineFarm:
    """Farm of pipelines: N data-parallel replicas of a K-chip pipeline.

    The composition point of the repo's two scaling axes (DESIGN.md §7.4):
    the replica axis is a `ChipFarm` (chip-axis stacked launches,
    reconciled pulse updates over the host link — bit for bit lockstep,
    and the serial chip's step up to the order of the batch sum), and the
    pipeline axis is the stage split of `ChipPipeline`, metered per
    replica on the inter-chip link.  Total chips = ``n_pipelines x
    n_chips_per_pipeline``.  The reference's device mesh (``mesh=``)
    waits for a multi-GPU host."""

    def __init__(self, layers: list[dict[str, torch.Tensor]],
                 spec: CrossbarSpec | None = None, *,
                 n_pipelines: int = 2,
                 max_cores_per_chip: int | None = None,
                 n_chips: int | None = None,
                 rows: int = CORE_ROWS, cols: int = CORE_COLS,
                 name: str = "pipeline_farm",
                 share_small_layers: bool = False,
                 input_bits: int = 8, device: str | torch.device = "cuda",
                 compiled: bool = True):
        from repro_torch.sim.cluster import ChipFarm
        self.farm = ChipFarm(layers, spec, n_chips=n_pipelines, rows=rows,
                             cols=cols, name=name,
                             share_small_layers=share_small_layers,
                             input_bits=input_bits, device=device,
                             compiled=compiled)
        if max_cores_per_chip is None and n_chips is None:
            max_cores_per_chip = hw.SYSTEM_CORES
        self.groups = split_network(self.farm.placement.nmap,
                                    max_cores_per_chip=max_cores_per_chip,
                                    n_chips=n_chips)
        dims = self.farm.placement.dims
        self.boundary_dims = tuple(dims[g[-1] + 1] for g in self.groups[:-1])
        self.n_pipelines = n_pipelines
        self.n_chips_per_pipeline = len(self.groups)
        self.link = InterChipLinkTracker()

    @property
    def total_chips(self) -> int:
        """Physical chips in the composed fabric (replicas x stages)."""
        return self.n_pipelines * self.n_chips_per_pipeline

    def train_step(self, x, target, lr: float, *,
                   reconcile: str = "none") -> torch.Tensor:
        """One data-parallel step over the pipeline replicas (numerics ==
        `ChipFarm.train_step`); every replica's wave crosses its pipeline
        boundaries with its batch shard, metered on the inter-chip link."""
        err = self.farm.train_step(x, target, lr, reconcile=reconcile)
        M = err.shape[0]                     # global batch over replicas
        for b, d in enumerate(self.boundary_dims):
            self.link.record_fwd(b, d * hw.ADC_BITS_OUT, M)
            self.link.record_bwd(b, d * hw.ERR_BITS_LINK, M)
        return err

    def serve(self, x) -> tuple[torch.Tensor, dict]:
        """Serve through the farm front-end; each retired sample crossed
        every pipeline boundary of its replica once."""
        out, stats = self.farm.serve(x)
        M = stats["retired"]
        for b, d in enumerate(self.boundary_dims):
            self.link.record_fwd(b, d * hw.ADC_BITS_OUT, M)
        return out, stats

    def replicas_in_sync(self) -> bool:
        """True when every pipeline replica holds identical conductances."""
        return self.farm.replicas_in_sync()

    def layers(self) -> list[dict[str, torch.Tensor]]:
        """Replica-0 conductances as per-layer dicts."""
        return self.farm.layers()

    def report(self):
        """(FarmReport, per-sample pipeline-link bits fwd/bwd) — the DP
        axis cross-validates via the farm contract, the pipeline axis via
        `hw_model.pipeline_cost` link bits."""
        return (self.farm.report(),
                {"link_bits_fwd": self.link.fwd_bits_per_sample(),
                 "link_bits_bwd": self.link.bwd_bits_per_sample()})
