"""Chip farm: N virtual chips under one host (port of ``repro.sim.cluster``).

The single-chip simulator (`repro_torch.sim.chip`) executes one placed
network; the farm scales it out:

  * ``ChipFarm`` — N data-parallel chip replicas.  Every stage's replicas
    live chip-major in one envelope (`placer.StageStacks` with ``chips =
    N``), each stage's ``(N, T_s)`` block a contiguous view, and every
    stage of every chip executes as ONE launch of a hand-written kernel
    with the chip axis folded into its core stack — never a Python loop
    over chips.

  * data-parallel training — each chip runs the paper's fwd/bwd phases on
    its batch shard, computes its LOCAL batch-summed outer product
    (`crossbar_dw_stacked`), and the host link reconciles:
    ``dist.collectives.farm_reduce_sum`` sums the contributions in chip
    order, the pulse discretization (III.F step 3) is applied ONCE to the
    sum, and every replica writes the same pulses.  So the replicas stay
    bitwise in lockstep, and the farm equals a serial
    `VirtualChip.train_step` on the unsharded batch up to the order of the
    batch sum (a pulse count within 1e-4 of k + 1/2 may round the other
    way).

  * ``FarmServer`` — the batched serving front-end: a
    `runtime.serve_loop.RequestQueue` with per-slot refill feeds each
    chip's stage-0 slot every pipeline beat; all stages of all chips
    evaluate in one stacked launch per beat (plus one aggregation launch
    when fan-in-split stages exist, eager), and each beat retires one
    request per chip at steady state — Table IV's 0.77 us beat, times N.

  * accounting — per-chip `PhaseCounters` (the single chip's conventions)
    plus a `HostLinkTracker` for sample ingress/egress and
    update-reconciliation traffic; `ChipFarm.report()` aggregates them into
    a `FarmReport` cross-validated against `hw_model.farm_cost`.

By default (``compiled=True``) the wave, the training step and a serving
session run through the compiled executor (`repro_torch.sim.compiled`):
one captured CUDA graph per (program, shapes) on the card.
``compiled=False`` is the eager per-stage path.  The reference's device
mesh (``make_farm_mesh``, ``ChipFarm(mesh=)``) waits for a multi-GPU host:
here the chip axis is an array axis on one device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import hw_model as hw
from repro_torch.core import quantization as q
from repro_torch.core.crossbar import (CORE_COLS, CORE_ROWS, CrossbarSpec,
                                       hard_sigmoid, hard_sigmoid_deriv)
from repro_torch.core.mapping import map_network
from repro_torch.dist.collectives import farm_reduce_sum
from repro_torch.kernels import ops as kernel_ops
from repro_torch.runtime.serve_loop import RequestQueue
from repro_torch.sim import compiled as csim
from repro_torch.sim.chip import VirtualChip, _tile_cols
from repro_torch.sim.noc import NocTracker
from repro_torch.sim.placer import (Placement, build_stage_stacks,
                                    fold_subneuron_partials, place_network,
                                    stage_dot_products,
                                    stage_dp_from_outputs, tile_inputs)
from repro_torch.sim.report import (FarmReport, HostLinkTracker,
                                    PhaseCounters, SimReport)


class ChipFarm:
    """N data-parallel chip replicas executing as chip-axis stacked
    launches."""

    def __init__(self, layers: list[dict[str, torch.Tensor]],
                 spec: CrossbarSpec | None = None, *,
                 n_chips: int = 2,
                 rows: int = CORE_ROWS, cols: int = CORE_COLS,
                 name: str = "farm", share_small_layers: bool = False,
                 input_bits: int = 8, device: str | torch.device = "cuda",
                 compiled: bool = True):
        self.device = resolve_device(device)
        self.compiled = compiled
        if spec is None:
            from repro_torch.configs.paper_apps import PAPER_SPEC
            spec = PAPER_SPEC
        if spec.split_activation:
            raise NotImplementedError(
                "the farm inherits the virtual chip's exact-aggregation "
                "restriction (split_activation=False)")
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        self.spec = spec
        self.name = name
        self.n_chips = n_chips
        self.input_bits = input_bits
        self.share_small_layers = share_small_layers
        self.version = 0            # bumped on every conductance write
        layers = [{k: torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
                   for k, v in p.items()} for p in layers]
        dims = [int(layers[0]["g_plus"].shape[0])] + \
               [int(p["g_plus"].shape[1]) for p in layers]
        nmap = map_network(dims, rows, cols,
                           share_small_layers=share_small_layers)
        self.placement: Placement = place_network(layers, nmap, rows, cols)
        # every stage's replicas, chip-major in one envelope; the eager and
        # the compiled path both update these views in place, and the
        # placement's stages show chip 0's replica
        self._stacks = build_stage_stacks(self.placement, chips=n_chips)
        views = [self._stacks.chip_views(s)
                 for s in range(self._stacks.S)]
        self._gp = [gp for gp, _ in views]      # (C, T_s, rows, cols)
        self._gm = [gm for _, gm in views]
        for st, gp, gm in zip(self.placement.stages, self._gp, self._gm):
            st.g_plus, st.g_minus = gp[0], gm[0]
        C = n_chips
        self.chip_infer = [PhaseCounters(
            noc=NocTracker(slot_cycles=self.placement.cols))
            for _ in range(C)]
        self.chip_train = [PhaseCounters(
            noc=NocTracker(slot_cycles=self.placement.cols))
            for _ in range(C)]
        self.serve_link = HostLinkTracker()
        self.train_link = HostLinkTracker()
        self.serve_beats = 0
        self.serve_sessions = 0          # each session pays one fill/drain
        # capacity is measured over FULL beats only (every chip retired):
        # a ragged request count leaves trailing slots idle, which is a
        # measurement artifact, not reduced farm capacity
        self.serve_full_beats = 0
        self.serve_full_samples = 0
        self.serve_full_requests = 0
        self.train_steps = 0

    # ------------------------------------------------------------------
    # Compiled whole-step executor (repro_torch.sim.compiled)
    # ------------------------------------------------------------------

    def _compiled_active(self) -> bool:
        """Whether the compiled executor runs (``compiled=True``)."""
        return self.compiled

    @property
    def _cfg(self) -> csim.ChipConfig:
        return csim.chip_config(self._stacks, self.spec)

    def _apply_phase_counters(self, counters: list[PhaseCounters],
                              fcnt: list[int], bcnt: list[int] | None,
                              Mc: int) -> None:
        """The compiled program's per-chip counters, fanned to every chip's
        `PhaseCounters` (replicas execute in lockstep, so the per-chip
        increments are identical), plus the static NoC replay."""
        st = self._stacks
        for c in counters:
            c.slots["fwd"] += fcnt[0]
            c.core_steps["fwd"] += fcnt[1]
            for s in range(st.S):
                c.noc.record(self.placement.stages[s].index,
                             st.routed[s], st.links[s], Mc)
            if bcnt is not None:
                c.slots["bwd"] += bcnt[0]
                c.core_steps["bwd"] += bcnt[1]
                c.slots["update"] += bcnt[2]
                c.core_steps["update"] += bcnt[3]

    # ------------------------------------------------------------------
    # Stage execution with a chip axis (eager)
    # ------------------------------------------------------------------

    def _count_stage(self, counters: list[PhaseCounters], st,
                     samples: int) -> None:
        links = st.g_plus.shape[0]
        for c in counters:
            c.record_phase("fwd", st.n_cores, samples)
            c.noc.record(st.index, st.lmap.routed_outputs, links, samples)

    def _forward(self, xb: torch.Tensor,
                 counters: list[PhaseCounters] | None
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Chip-axis wave with the reference transport semantics: one
        forward launch per stage over every chip's cores (and one for a
        Fig.-14 aggregation stage).  No gradient flows through the wave,
        so the links carry the hard ADC — the compiled program's — where
        the reference writes its straight-through form (which may move a
        code by one ulp)."""
        acts, dps = [], []
        h = xb
        last = len(self.placement.stages) - 1
        for si, st in enumerate(self.placement.stages):
            acts.append(h)
            dp = stage_dot_products(st, h, self._gp[si], self._gm[si],
                                    kernel_ops.crossbar_fwd_stacked)
            dps.append(dp)
            if counters is not None:
                self._count_stage(counters, st, xb.shape[1])
            h = hard_sigmoid(dp)
            if si < last and self.spec.transport_quant:
                h = q.adc_quantize(h, self.spec.adc_bits)
        return acts, dps

    def _split(self, x, what: str) -> torch.Tensor:
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32,
                                             device=self.device))
        M = x.shape[0]
        if M % self.n_chips:
            raise ValueError(
                f"{what} batch {M} does not divide over {self.n_chips} "
                f"chips")
        return x.reshape(self.n_chips, M // self.n_chips, x.shape[1])

    # ------------------------------------------------------------------
    # Inference (wave semantics; serving goes through FarmServer)
    # ------------------------------------------------------------------

    def infer(self, x, *, count: bool = True) -> torch.Tensor:
        """Data-parallel recognition wave: the global batch splits over
        chips, each replica computes its shard; rows come back in input
        order and equal `VirtualChip.infer` on the unsharded batch."""
        xb = self._split(x, "infer")
        counters = self.chip_infer if count else None
        if self._compiled_active():
            out, fcnt = csim.chip_infer(self._stacks, xb, self._cfg)
            if count:
                self._apply_phase_counters(counters, fcnt, None,
                                           xb.shape[1])
        else:
            _, dps = self._forward(xb, counters)
            out = hard_sigmoid(dps[-1])
        if count:
            Mc = xb.shape[1]
            bits = (self.placement.dims[0] * self.input_bits
                    + self.placement.dims[-1] * hw.ADC_BITS_OUT)
            for c in self.chip_infer:
                c.samples += Mc
                c.record_io(bits, Mc)
        return out.reshape(-1, out.shape[-1])

    # ------------------------------------------------------------------
    # Data-parallel training with reconciled pulse updates
    # ------------------------------------------------------------------

    def train_step(self, x, target, lr: float, *,
                   reconcile: str = "none") -> torch.Tensor:
        """One farm step on the global batch; equals the serial
        `VirtualChip.train_step` on the same data when ``reconcile`` is
        "none" (up to the order of the batch sum).  Mode "int8" codes each
        chip's contribution in the 8-bit wire format the link accounting
        already meters (bounded deviation from the serial chip); mode
        "none" idealizes an exact sum over that same metered traffic.
        Returns the (global) output error."""
        xb = self._split(x, "train")
        tb = self._split(target, "target")
        spec = self.spec
        C, Mc = xb.shape[0], xb.shape[1]
        M = C * Mc

        if self._compiled_active():
            # the whole farm step — chip-axis wave, reversed bwd loop,
            # reconciliation, pulses into every replica — is ONE program
            err, fcnt, bcnt = csim.chip_train(
                self._stacks, xb, tb, self._cfg, lr_eff=float(lr) / M,
                reconcile=reconcile)
            self._apply_phase_counters(self.chip_train, fcnt, bcnt, Mc)
        else:
            if reconcile not in ("none", "int8"):
                raise ValueError(
                    f"unknown farm reduction mode: {reconcile!r}")
            err = self._eager_step(xb, tb, lr / M, reconcile)
        bits = (2 * self.placement.dims[0] * self.input_bits
                + self.placement.dims[-1] * hw.ADC_BITS_OUT)
        for c in self.chip_train:
            c.samples += Mc
            c.record_io(bits, Mc)
        self.train_link.record_samples(bits, M)
        self.train_link.record_reconcile(C * self._reconcile_bits())
        self.train_steps += 1
        self.version += 1
        return err.reshape(M, -1)

    def _eager_step(self, xb: torch.Tensor, tb: torch.Tensor, lr_eff: float,
                    reconcile: str) -> torch.Tensor:
        """The eager farm step: per stage one bwd and one dw launch over
        every chip's cores, the reconciled pulse written in place into
        every replica.  Returns the (C, Mc, out) output error."""
        spec = self.spec
        C, Mc = xb.shape[0], xb.shape[1]
        acts, dps = self._forward(xb, self.chip_train)
        err = tb - hard_sigmoid(dps[-1])
        delta = err
        for si in reversed(range(len(self.placement.stages))):
            st = self.placement.stages[si]
            r, ct = st.row_tiles, st.col_tiles
            if spec.error_quant:
                # shared full-scale across the farm: quantizing the global
                # tensor IS max-abs over every chip's shard (a farm_max in
                # the distributed view) — the replicas discretize on the
                # serial chip's grid (III.F step 1)
                delta = (q.error_quantize(delta.reshape(C * Mc, -1),
                                          spec.err_bits)
                         .dequantize().reshape(C, Mc, -1))
            local = delta * hard_sigmoid_deriv(dps[si])

            ds = _tile_cols(local, r, ct, st.cols)      # (C, T, Mc, cols)
            dxs = kernel_ops.crossbar_bwd_stacked(ds, self._gp[si],
                                                  self._gm[si])
            dx = (dxs.reshape(C, r, ct, Mc, st.rows).sum(dim=2)
                     .transpose(1, 2).reshape(C, Mc, r * st.rows))
            delta_prev = dx[..., 1:st.lmap.fan_in + 1]
            for c in self.chip_train:
                c.record_phase("bwd", st.n_cores, Mc)

            # update: LOCAL outer products (one farm-wide launch), then
            # the host reconciles and every replica pulses identically.
            xs = tile_inputs(acts[si], r, ct, st.rows)
            dw_local = kernel_ops.crossbar_dw_stacked(xs, ds)
            dw = 2.0 * lr_eff * farm_reduce_sum(dw_local, mode=reconcile)
            if spec.update_quant:
                dw = q.pulse_discretize(dw, spec.max_update,
                                        spec.update_levels)
            torch.clamp(self._gp[si] + 0.5 * dw, 0.0, spec.w_max,
                        out=self._gp[si])
            torch.clamp(self._gm[si] - 0.5 * dw, 0.0, spec.w_max,
                        out=self._gm[si])
            for c in self.chip_train:
                c.record_phase("update", st.n_cores, Mc)

            delta = delta_prev
        return err

    def _reconcile_bits(self) -> int:
        """Host-link bits one chip's update reconciliation moves per step:
        its local dw codes up + the reconciled pulses down, ERR_BITS_LINK
        bits per placed main-grid cell each way (measured from the actual
        stack sizes).  The wire format is always the paper's 8-bit codes —
        `hw_model.farm_cost` prices the same constant — so the metered
        traffic does not depend on the ``reconcile`` mode; "none" is a
        numerics idealization (exact sum), not a wider link."""
        cells = sum(gp[0].numel() for gp in self._gp)
        return 2 * cells * hw.ERR_BITS_LINK

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def serve(self, x) -> tuple[torch.Tensor, dict]:
        """Serve a batch of requests (one per row) through the pipelined
        farm; returns (outputs in request order, serving stats)."""
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32,
                                             device=self.device))
        if x.shape[0] == 0:
            return (torch.zeros((0, self.placement.dims[-1]),
                                device=self.device),
                    {"beats": 0, "retired": 0, "beat_us": self.beat_us,
                     "makespan_us": 0.0, "samples_per_s": 0.0,
                     "occupancy": 0.0})
        server = FarmServer(self)
        queue = RequestQueue(list(x))
        stats = server.run(queue)
        out = torch.stack([r.reshape(-1) for r in queue.results()])
        return out, stats

    # ------------------------------------------------------------------
    # Introspection / reporting
    # ------------------------------------------------------------------

    @property
    def beat_us(self) -> float:
        """Steady-state pipeline beat of every chip (Table IV)."""
        return hw.pipeline_beat_us(self.placement.cols)

    def layers(self) -> list[dict[str, torch.Tensor]]:
        """Chip-0 replica's conductances as per-layer dicts (replicas are
        in lockstep)."""
        return self.extract_chip(0).layers()

    def extract_chip(self, i: int) -> VirtualChip:
        """Materialize chip ``i`` as a standalone VirtualChip (a copy of
        its conductances)."""
        stages = [dataclasses.replace(st, g_plus=self._gp[si][i].clone(),
                                      g_minus=self._gm[si][i].clone())
                  for si, st in enumerate(self.placement.stages)]
        pl = Placement(stages=stages, dims=self.placement.dims,
                       rows=self.placement.rows, cols=self.placement.cols,
                       nmap=self.placement.nmap)
        return VirtualChip([], self.spec, name=f"{self.name}.chip{i}",
                           input_bits=self.input_bits, placement=pl,
                           device=self.device, compiled=self.compiled)

    def replicas_in_sync(self) -> bool:
        """True when every chip holds bitwise-identical conductances."""
        return all(bool((g == g[:1]).all())
                   for gp, gm in zip(self._gp, self._gm) for g in (gp, gm))

    def _chip_report(self, i: int) -> SimReport:
        inf, tr = self.chip_infer[i], self.chip_train[i]
        beat = self.beat_us
        return SimReport(
            name=f"{self.name}.chip{i}", dims=self.placement.dims,
            cores=self.placement.n_cores,
            infer_samples=inf.samples, train_samples=tr.samples,
            infer_time_us=inf.time_us() if inf.samples else 0.0,
            infer_energy_j=inf.core_energy_j() if inf.samples else 0.0,
            infer_io_j=inf.io_energy_j() if inf.samples else 0.0,
            train_time_us=tr.time_us() if tr.samples else 0.0,
            train_energy_j=(tr.core_energy_j(include_ctrl=True)
                            if tr.samples else 0.0),
            train_io_j=tr.io_energy_j() if tr.samples else 0.0,
            beat_us=beat, throughput_sps=1e6 / beat,
            routed_per_sample=(
                inf.noc.routed_outputs_per_sample(inf.samples)
                if inf.samples
                else tr.noc.routed_outputs_per_sample(tr.samples)),
            link_utilization=(inf.noc.link_utilization if inf.samples
                              else tr.noc.link_utilization),
        )

    def report(self) -> FarmReport:
        """Aggregate the per-chip counters + host-link tracker into a
        `FarmReport`, carrying the matching analytic `hw_model.farm_cost`
        for cross-validation."""
        per_chip = tuple(self._chip_report(i) for i in range(self.n_chips))
        beat = self.beat_us
        serve_samples = self.serve_link.samples
        # capacity from FULL beats only (fill/drain and ragged final
        # beats are measurement artifacts, not reduced capacity); 0 when
        # no beat ever filled every slot — compare_hw then skips the
        # throughput comparison
        serve_sps = (self.serve_full_samples
                     / (self.serve_full_beats * beat) * 1e6
                     if self.serve_full_beats else 0.0)
        slot_m = (self.serve_full_samples / self.serve_full_requests
                  if self.serve_full_requests else 1.0)
        link = self.serve_link
        serve_bits = link.sample_bits_per_sample()
        # per-sample chip energy is uniform across wave-inferred and served
        # samples (each bills one full pipeline), so average over all of
        # them even when both paths ran.
        infer_samples = sum(r.infer_samples for r in per_chip)
        chip_serve_j = (sum(r.infer_total_j * r.infer_samples
                            for r in per_chip) / infer_samples
                        if infer_samples else 0.0)
        serve_j = chip_serve_j + link.energy_j(serve_bits)

        train_samples = sum(r.train_samples for r in per_chip)
        train_bits = self.train_link.sample_bits_per_sample()
        recon_bits = self.train_link.reconcile_bits_per_step()
        if self.train_steps:
            per_chip_batch = (train_samples // self.n_chips
                              // self.train_steps)
            chip_t = per_chip[0].train_time_us
            step_us = per_chip_batch * chip_t + self.train_link.time_us(
                recon_bits / self.n_chips)
            chip_train_j = sum(r.train_total_j * r.train_samples
                               for r in per_chip) / train_samples
            train_j = chip_train_j + self.train_link.energy_j(train_bits) \
                + self.train_link.energy_j(recon_bits) * self.train_steps \
                / train_samples
        else:
            per_chip_batch = 1
            step_us = train_j = 0.0
        analytic = hw.farm_cost(
            self.name, list(self.placement.dims), self.n_chips,
            batch_per_chip=max(per_chip_batch, 1),
            input_bits=self.input_bits,
            share_small_layers=self.share_small_layers,
            rows=self.placement.rows, cols=self.placement.cols)
        return FarmReport(
            name=self.name, n_chips=self.n_chips, dims=self.placement.dims,
            per_chip=per_chip, beat_us=beat,
            serve_samples=serve_samples, serve_beats=self.serve_beats,
            serve_samples_per_s=serve_sps, serve_j_per_sample=serve_j,
            train_samples=train_samples, train_steps=self.train_steps,
            train_step_us=step_us, train_j_per_sample=train_j,
            host_serve_bits=serve_bits, host_train_bits=train_bits,
            host_reconcile_bits=recon_bits,
            host_link_utilization=(link.time_us(serve_bits) / beat
                                   if serve_samples else 0.0),
            host_serve_bits_total=self.serve_link.sample_bits,
            host_train_bits_total=self.train_link.sample_bits,
            host_reconcile_bits_total=self.train_link.reconcile_bits,
            serve_slot_m=slot_m,
            analytic=analytic,
        )


def build_farm(app: str, n_chips: int, *, seed: int = 0,
               share_small_layers: bool = False, spec=None,
               device: str | torch.device = "cuda",
               compiled: bool = True) -> ChipFarm:
    """A farm of ``n_chips`` replicas of one paper application, its
    conductances drawn from ``seed`` on the CPU (as `launch.chipsim`'s
    ``build_chip`` draws them), so every device gets the same weights."""
    from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
    from repro_torch.core import crossbar as xb
    spec = PAPER_SPEC if spec is None else spec
    device = resolve_device(device)
    dims = NETWORKS[app]
    gen = torch.Generator().manual_seed(seed)
    layers = [xb.init_conductances(f, o, spec, generator=gen, device=device)
              for f, o in zip(dims, dims[1:])]
    return ChipFarm(layers, spec, n_chips=n_chips, name=app,
                    share_small_layers=share_small_layers, device=device,
                    compiled=compiled)


class FarmServer:
    """Pipelined serving front-end: one stacked forward launch per beat.

    Wavefront execution (Fig. 2 at farm scale): sample ``k`` occupies
    stage ``s`` of its chip at beat ``enter_k + s``; every beat the server
    assembles the (C, sumT, m, rows) input slab of ALL stages of ALL
    chips, runs ONE `crossbar_fwd_stacked` launch (plus one aggregation
    launch when fan-in-split stages exist), advances the wavefront, and
    refills each chip's stage-0 slot from the request queue.  Stages are
    sample-independent, so served outputs equal `mlp_forward` up to
    summation order; what the beat loop adds is the *time* structure the
    farm throughput claim is made from.  A fresh server draining a
    uniform-shape queue on a compiled farm runs the whole session as one
    captured beat replayed per beat (`compiled.run_serve_session`), on the
    same snapshot of the stacks.
    """

    def __init__(self, farm: ChipFarm):
        self.farm = farm
        self._version = farm.version     # conductance snapshot guard
        pl = farm.placement
        self.stages = pl.stages
        self.S = len(self.stages)
        self.C = farm.n_chips
        self.rows = pl.rows
        # chip-major stacks: chip c's cores for all stages, concatenated
        # (a snapshot: a later train_step does not reach this server)
        self._off = []
        off = 0
        for st in self.stages:
            self._off.append(off)
            off += st.g_plus.shape[0]
        self.sumT = off
        self._stack_p = torch.cat(farm._gp, dim=1)   # (C, sumT, R, cols)
        self._stack_m = torch.cat(farm._gm, dim=1)
        # aggregation stacks (fan-in-split stages), padded to a common
        # input-line count
        self._agg_idx = [si for si, st in enumerate(self.stages)
                         if st.row_tiles > 1]
        if self._agg_idx:
            self._agg_rows = max(self.stages[si].agg_plus.shape[1]
                                 for si in self._agg_idx)
            self._agg_off = []
            parts_p, parts_m = [], []
            aoff = 0
            for si in self._agg_idx:
                st = self.stages[si]
                self._agg_off.append(aoff)
                aoff += st.agg_plus.shape[0]
                pad = self._agg_rows - st.agg_plus.shape[1]
                parts_p.append(torch.nn.functional.pad(st.agg_plus,
                                                       (0, 0, 0, pad)))
                parts_m.append(torch.nn.functional.pad(st.agg_minus,
                                                       (0, 0, 0, pad)))
            self._agg_p = torch.cat(parts_p).expand(
                (self.C,) + (aoff, self._agg_rows, pl.cols)).contiguous()
            self._agg_m = torch.cat(parts_m).expand(
                (self.C,) + (aoff, self._agg_rows, pl.cols)).contiguous()
        # wavefront: pipe[c][s] = (rid, input activation) or None
        self.pipe: list[list] = [[None] * self.S for _ in range(self.C)]
        self._slot_m: int | None = None   # uniform request batch size

    def _check_snapshot(self) -> None:
        if self.farm.version != self._version:
            raise RuntimeError(
                "farm conductances changed since this FarmServer was "
                "built (a train_step ran); construct a fresh server — "
                "the serving stacks are a snapshot")

    # -- one pipeline beat ------------------------------------------------

    def step(self, queue: RequestQueue) -> int:
        """Advance the farm one beat; returns samples retired."""
        farm = self.farm
        self._check_snapshot()
        spec = farm.spec
        for c in range(self.C):
            if self.pipe[c][0] is None:
                req = queue.pop()
                if req is not None:
                    x = torch.atleast_2d(torch.as_tensor(
                        req.x, dtype=torch.float32, device=farm.device))
                    # the beat slab needs one static shape: all requests
                    # of a serving session must share their microbatch
                    if self._slot_m is None:
                        self._slot_m = x.shape[0]
                    elif x.shape[0] != self._slot_m:
                        raise ValueError(
                            f"request {req.rid} has microbatch "
                            f"{x.shape[0]}, session uses {self._slot_m}; "
                            f"serve uniform request shapes")
                    self.pipe[c][0] = (req.rid, x)
        m = next((slot[1].shape[0] for lane in self.pipe
                  for slot in lane if slot is not None), None)
        if m is None:
            return 0

        # assemble the farm-wide input slab (idle slots drive zeros; their
        # outputs are discarded and their stages not billed)
        slabs = []
        for c in range(self.C):
            parts = []
            for s, st in enumerate(self.stages):
                if self.pipe[c][s] is not None:
                    parts.append(tile_inputs(self.pipe[c][s][1],
                                             st.row_tiles, st.col_tiles,
                                             st.rows))
                else:
                    parts.append(torch.zeros(
                        (st.g_plus.shape[0], m, st.rows),
                        device=farm.device))
            slabs.append(torch.cat(parts))
        xs = torch.stack(slabs)                     # (C, sumT, m, rows)
        ys = kernel_ops.crossbar_fwd_stacked(xs, self._stack_p,
                                             self._stack_m)

        # aggregation launch for fan-in-split stages (same time slot);
        # input-line folding shared with the wave paths via
        # `placer.fold_subneuron_partials`
        agg_out = None
        if self._agg_idx:
            aparts = []
            for si in self._agg_idx:
                st = self.stages[si]
                o = self._off[si]
                u = fold_subneuron_partials(
                    ys[:, o:o + st.row_tiles * st.col_tiles], st)
                aparts.append(torch.nn.functional.pad(
                    u, (0, self._agg_rows - u.shape[-1])))
            agg_out = kernel_ops.crossbar_fwd_stacked(
                torch.cat(aparts, dim=1), self._agg_p, self._agg_m)

        # per-stage dot products -> outputs, advance the wavefront
        new_pipe: list[list] = [[None] * self.S for _ in range(self.C)]
        retired = 0
        retired_requests = 0
        bits = (farm.placement.dims[0] * farm.input_bits
                + farm.placement.dims[-1] * hw.ADC_BITS_OUT)
        for s, st in enumerate(self.stages):
            r, ct = st.row_tiles, st.col_tiles
            o = self._off[s]
            agg_slice = None
            if r > 1:
                ao = self._agg_off[self._agg_idx.index(s)]
                agg_slice = agg_out[:, ao:ao + ct]  # (C, ct, m, cols)
            dp = stage_dp_from_outputs(ys[:, o:o + r * ct], st, agg_slice)
            for c in range(self.C):
                if self.pipe[c][s] is None:
                    continue
                rid, _ = self.pipe[c][s]
                farm._count_stage([farm.chip_infer[c]], st, m)
                h = hard_sigmoid(dp[c])
                if s < self.S - 1:
                    if spec.transport_quant:     # the hard ADC, as _forward
                        h = q.adc_quantize(h, spec.adc_bits)
                    new_pipe[c][s + 1] = (rid, h)
                else:
                    queue.complete(rid, h)
                    retired += m
                    retired_requests += 1
                    farm.serve_link.record_samples(bits, m)
                    farm.chip_infer[c].samples += m
                    farm.chip_infer[c].record_io(bits, m)
        if retired_requests == self.C:      # every slot retired: capacity
            farm.serve_full_beats += 1
            farm.serve_full_samples += retired
            farm.serve_full_requests += retired_requests
        self.pipe = new_pipe
        farm.serve_beats += 1
        return retired

    def _stats(self, beats: int, retired: int, requests: int,
               steady: int) -> dict:
        """Serving stats of a session (eager and compiled alike)."""
        beat_us = self.farm.beat_us
        return {
            "beats": beats,
            "retired": retired,
            "beat_us": beat_us,
            "makespan_us": beats * beat_us,
            "samples_per_s": retired / (steady * beat_us) * 1e6,
            # fraction of (chip, stage) slots occupied over the session
            "occupancy": requests * self.S / max(self.S * self.C * beats, 1),
        }

    def _run_compiled(self, queue: RequestQueue) -> dict:
        """The whole serving session as one compiled beat program: the
        wavefront schedule of `step` is static — request ``r`` enters chip
        ``r % C`` at beat ``r // C`` — so one captured beat replays for
        every beat.  Counters replay the same static schedule host-side
        (identical totals to the eager loop)."""
        farm = self.farm
        self._check_snapshot()
        farm.serve_sessions += 1
        C = self.C
        Q, m, q_max, n_beats = csim.run_serve_session(
            queue, farm._stacks, self._stack_p, self._stack_m, farm.spec, C)
        self._slot_m = m

        # counters: the eager loop's per-beat billing, aggregated over the
        # static schedule (lane c serves ceil((Q - c) / C) requests)
        bits = (farm.placement.dims[0] * farm.input_bits
                + farm.placement.dims[-1] * hw.ADC_BITS_OUT)
        for c in range(C):
            n = (Q - c + C - 1) // C * m
            if not n:
                continue
            cc = farm.chip_infer[c]
            for stg in self.stages:
                cc.record_phase("fwd", stg.n_cores, n)
                cc.noc.record(stg.index, stg.lmap.routed_outputs,
                              stg.g_plus.shape[0], n)
            cc.samples += n
            cc.record_io(bits, n)
        farm.serve_link.record_samples(bits, Q * m)
        full = Q // C
        farm.serve_full_beats += full
        farm.serve_full_samples += full * C * m
        farm.serve_full_requests += full * C
        farm.serve_beats += n_beats
        return self._stats(n_beats, Q * m, Q, q_max)

    def run(self, queue: RequestQueue, *, max_beats: int | None = None
            ) -> dict:
        """Drain the queue; returns serving stats.

        On a compiled farm, a fresh server draining a uniform-shape queue
        runs the whole session as one compiled beat program; step-wise use
        (partially drained pipes, beat limits, ragged shapes) stays on the
        eager per-beat path."""
        if (self.farm._compiled_active() and max_beats is None
                and csim.serve_session_applicable(
                    queue, all(s is None for lane in self.pipe
                               for s in lane), self._slot_m)):
            return self._run_compiled(queue)
        beats = retired = 0
        limit = max_beats if max_beats is not None else 10_000_000
        self.farm.serve_sessions += 1
        done_before = queue.completed
        while not queue.drained and beats < limit:
            retired += self.step(queue)
            beats += 1
        return self._stats(beats, retired, queue.completed - done_before,
                           max(beats - (self.S - 1), 1))
