"""Compiled whole-step execution for the virtual chip (port of
``repro.sim.compiled``).

The eager simulator drives every stage from Python: a dozen small
PyTorch operations and one or two kernel launches per stage per phase,
each enqueued by the host while the device waits.  The paper's chip has
no host in the loop: the whole network step is a fixed schedule.  This
module is that schedule for the simulator.  The recognition wave, the
training step (forward wave + reversed backward/update loop) and the
farm's serving beat each run as ONE program per (topology, shapes):

  * on the card, a captured ``torch.cuda.CUDAGraph``: the stage loop runs
    once under capture and every later call replays it, so the host
    enqueues one graph launch instead of every operation;
  * on the CPU, the same stage loop, run on every call (one built program
    per key, counted the same way).

As in the reference, every stage loop carries a leading *chip* axis: the
serial chip is the C == 1 case of the farm (``repro_torch.sim.cluster``),
whose replicas live chip-major in one envelope
(`placer.StageStacks.chip_views`), so a stage launches once over its
(C, T_s) cores with the chip axis folded into the core stack.

The stage loop (the reference's ``lax.scan``) walks the padded
`placer.StageStacks`, but each stage launches on its own ``T_s`` cores —
the view ``envelope[s, :C*T_s]`` — and indexes with its own slice of the
maps (`placer.StageMaps`), so no launch shape and no sum depends on the
envelope: a stage computes the same bits inside any envelope, which is
what the pipeline fabric's slice-versus-serial pins rest on.  The
reference's padded terms (trailing zero cores, zero lanes, zero fan-in
tiles) are exact zeros, so skipping them changes no value.

  * The Fig.-14 aggregation is a gather and a sequential sum over the
    stage's fan-in tiles (no aggregation-core launch): a wave launches
    ``crossbar_fwd`` once per stage.
  * The chip's training body is the fused kernel
    (`kernels/ops.crossbar_train_stacked`), whose new conductances are
    copied into the envelope in place: a step launches ``crossbar_fwd``
    and ``crossbar_train`` once per stage, and the envelope keeps its
    memory (the port's form of the reference's buffer donation).
  * The farm's training body (``reconcile in ("none", "int8")``) launches
    ``crossbar_bwd`` and ``crossbar_dw`` once per stage over every chip's
    cores, reconciles the local outer products with
    `dist.collectives.farm_reduce_sum`, discretizes the pulse once on the
    sum and writes the clamped update into every replica in place.
  * ``lr_eff = lr / B`` lives in a one-element fp32 device buffer written
    before each call, so an lr schedule replays the same graph.
  * Counters are the reference's ``[fwd_slots, fwd_core_steps]`` and
    ``[b_slots, b_steps, u_slots, u_steps]`` per chip.  They depend on
    shapes only, so the stage loop counts them on the host when it runs
    and a replay returns the same numbers: no device read at all.
  * Launch counts: under capture the wrappers' ``launches`` tick without
    anything running, so a capture records each graph's launches, takes
    them back, and adds them on every replay — ``launches`` keeps
    counting launches executed (`graphs.Graph`, which the LM server's
    captured decode step shares).
  * Serving (`run_serve_session`): one beat — every stage of every lane in
    ONE forward launch over their concatenated cores, the aggregation a
    gather-sum — is captured once per (lanes, microbatch, padded queue)
    and replayed once per beat; the beat index is a device buffer the
    beat advances itself, so a session enqueues only graph launches.

In place of ``trace_counts`` the module counts built programs per
(program, config, shapes) (`capture_counts`).  A captured graph bakes in
the envelope's addresses, so programs live on the `StageStacks` they were
built for: two chips of one topology build one program each.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, NamedTuple

import torch

from repro_torch import graphs
from repro_torch.core import quantization as q
from repro_torch.core.crossbar import hard_sigmoid, hard_sigmoid_deriv
from repro_torch.dist.collectives import farm_reduce_sum
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sim.placer import StageMaps, StageStacks

# ---------------------------------------------------------------------------
# Build accounting (one program per (program, config, shapes))
# ---------------------------------------------------------------------------

_CAPTURES: Counter = Counter()


def capture_counts() -> dict:
    """Snapshot of the build counter: {(program, cfg, *shapes): builds}."""
    return dict(_CAPTURES)


def reset_capture_counts() -> None:
    """Clear the build counter (built programs stay on their stacks, so a
    re-run after a reset shows no new builds)."""
    _CAPTURES.clear()


class ChipConfig(NamedTuple):
    """Static (hashable) configuration of a compiled chip program: the
    `StageStacks` envelope geometry plus the `CrossbarSpec` constants the
    stage loop branches on."""
    S: int
    T_max: int
    r_max: int
    c_max: int
    rows: int
    cols: int
    L: int
    N_pad: int
    out_dim: int
    transport_quant: bool
    adc_bits: int
    error_quant: bool
    err_bits: int
    update_quant: bool
    max_update: float
    update_levels: int
    w_max: float


def chip_config(stacks: StageStacks, spec) -> ChipConfig:
    """Build the static program config from a `StageStacks` + spec."""
    return ChipConfig(
        S=stacks.S, T_max=stacks.T_max, r_max=stacks.r_max,
        c_max=stacks.c_max, rows=stacks.rows, cols=stacks.cols,
        L=stacks.L, N_pad=stacks.N_pad, out_dim=stacks.out_dim,
        transport_quant=bool(spec.transport_quant),
        adc_bits=int(spec.adc_bits),
        error_quant=bool(spec.error_quant), err_bits=int(spec.err_bits),
        update_quant=bool(spec.update_quant),
        max_update=float(spec.max_update),
        update_levels=int(spec.update_levels), w_max=float(spec.w_max))


# ---------------------------------------------------------------------------
# The stage loop (a leading chip axis throughout: the serial chip is C = 1)
# ---------------------------------------------------------------------------

def _embed(h: torch.Tensor) -> torch.Tensor:
    """(C, M, W) activation -> (C, M, 1 + W) input vector: the always-zero
    bias slot 0, then the payload."""
    return torch.nn.functional.pad(h, (1, 0))


def _gather_cores(v: torch.Tensor, idx: torch.Tensor,
                  T: int) -> torch.Tensor:
    """(C, M, lanes) values -> (C*T, M, width) per-core slabs through a
    flat (T*width,) index map, chip-major (the envelope's order)."""
    C, M = v.shape[0], v.shape[1]
    return (v.index_select(2, idx).reshape(C, M, T, -1).transpose(1, 2)
             .reshape(C * T, M, -1))


def _envelope(stacks: StageStacks, s: int, m: StageMaps):
    """Stage ``s``'s own cores, every chip's: contiguous (C*T, rows, cols)
    views of the envelope."""
    n = stacks.chips * m.T
    return stacks.g_plus[s, :n], stacks.g_minus[s, :n]


def _stage_dp(h_ext: torch.Tensor, stacks: StageStacks, s: int,
              m: StageMaps) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage's core inputs ``xs`` (C*T, M, rows) and exact-aggregated
    dot products (C, M, fan_out): one forward launch over every chip's
    cores, then the Fig.-14 aggregation as a sequential sum over the
    fan-in tiles."""
    C, M = h_ext.shape[0], h_ext.shape[1]
    xs = _gather_cores(h_ext, m.in_idx, m.T)
    ys = kernel_ops.crossbar_fwd_stacked(xs, *_envelope(stacks, s, m))
    ys_flat = ys.reshape(C, m.T, M, -1).transpose(1, 2).reshape(C, M, -1)
    dp = ys_flat.index_select(2, m.dp_idx[0])
    for i in range(1, m.r):
        dp = dp + ys_flat.index_select(2, m.dp_idx[i])
    return xs, dp


def _forward_scan(stacks: StageStacks, x: torch.Tensor, quantize_tail: bool,
                  cfg: ChipConfig):
    """Wave through all stages; ``x`` is (C, M, fan_in).  Returns (core
    inputs per stage, embedded stage inputs (C, M, 1 + fan_in), dot
    products (C, M, fan_out), tail activation, counters [fwd_slots,
    fwd_core_steps] per chip)."""
    M = x.shape[1]
    h_ext = _embed(x)
    xs_all, acts, dps = [], [], []
    cnt = [0, 0]
    for s, m in enumerate(stacks.stage_maps):
        acts.append(h_ext)
        xs, dp = _stage_dp(h_ext, stacks, s, m)
        xs_all.append(xs)
        dps.append(dp)
        h = hard_sigmoid(dp)
        if cfg.transport_quant and (s < cfg.S - 1 or quantize_tail):
            h = q.adc_quantize(h, cfg.adc_bits)
        cnt[0] += M
        cnt[1] += M * m.cores
        h_ext = _embed(h)
    return xs_all, acts, dps, h, cnt


def _backward_scan(stacks: StageStacks, xs_all, dps, delta: torch.Tensor,
                   lr_eff: torch.Tensor, cfg: ChipConfig,
                   reconcile: str | None = None):
    """Backward + update phases over the stages in reverse, the envelope
    updated in place; ``delta`` is (C, M, out).  Returns (error at the
    first stage's input, counters [b_slots, b_steps, u_slots, u_steps] per
    chip).

    ``reconcile is None`` is the serial chip (C = 1): the fused kernel
    writes the stage's pulse update.  ``reconcile in ("none", "int8")`` is
    the farm: the error quantized with the farm-wide full-scale, one bwd
    and one dw launch over every chip's cores, `farm_reduce_sum` of the
    local outer products, the pulse discretized once on the sum and the
    clamped update written into every replica (the fused kernel's pulse
    is per chip, so it does not apply)."""
    C, M = delta.shape[0], delta.shape[1]
    cnt = [0, 0, 0, 0]
    for s in reversed(range(cfg.S)):
        m = stacks.stage_maps[s]
        gp_s, gm_s = _envelope(stacks, s, m)
        if cfg.error_quant:
            # III.F step 1: errors ride the links as 8-bit codes, one
            # full-scale over the whole (farm-wide) batch
            delta = (q.error_quantize(delta.reshape(C * M, -1), cfg.err_bits)
                     .dequantize().reshape(C, M, -1))
        local = delta * hard_sigmoid_deriv(dps[s])
        ds = _gather_cores(torch.nn.functional.pad(local, (0, 1)),
                           m.ds_idx, m.T)                 # (C*T, M, cols)
        if reconcile is not None:
            dxs = kernel_ops.crossbar_bwd_stacked(ds, gp_s, gm_s)
            dw_local = kernel_ops.crossbar_dw_stacked(xs_all[s], ds)
            dw = (2.0 * lr_eff) * farm_reduce_sum(
                dw_local.view(C, m.T, cfg.rows, cfg.cols), mode=reconcile)
            if cfg.update_quant:
                dw = q.pulse_discretize(dw, cfg.max_update,
                                        cfg.update_levels)
            gp_c, gm_c = stacks.chip_views(s)
            torch.clamp(gp_c + 0.5 * dw, 0.0, cfg.w_max, out=gp_c)
            torch.clamp(gm_c - 0.5 * dw, 0.0, cfg.w_max, out=gm_c)
        elif cfg.update_quant:
            # the fused kernel: bwd + dw + pulse update, into the envelope
            _, dxs, _, _ = kernel_ops.crossbar_train_stacked(
                gp_s, gm_s, xs_all[s], ds, lr=lr_eff,
                max_dw=cfg.max_update, levels=cfg.update_levels,
                w_max=cfg.w_max, inplace=True)
        else:
            dxs = kernel_ops.crossbar_bwd_stacked(ds, gp_s, gm_s)
            dw = (2.0 * lr_eff) * torch.einsum("tmk,tmn->tkn", xs_all[s], ds)
            torch.clamp(gp_s + 0.5 * dw, 0.0, cfg.w_max, out=gp_s)
            torch.clamp(gm_s - 0.5 * dw, 0.0, cfg.w_max, out=gm_s)
        # fan-in fold: fan-in tile i sums its fan-out tiles in order
        dxs = dxs.view(C, m.T, M, cfg.rows)
        dxg = dxs.index_select(1, m.fold_idx[:, 0])
        for j in range(1, m.c):
            dxg = dxg + dxs.index_select(1, m.fold_idx[:, j])
        dxg_flat = dxg.transpose(1, 2).reshape(C, M, -1)  # (C, M, r*rows)
        delta = dxg_flat.index_select(2, m.prev_idx)      # strip bias line
        cnt = [cnt[0] + M, cnt[1] + M * m.cores, cnt[2] + M,
               cnt[3] + M * m.cores]
    return delta, cnt


# ---------------------------------------------------------------------------
# Programs: one per (program, config, shapes) on a StageStacks
# ---------------------------------------------------------------------------

class _Program:
    """One built program: a captured CUDA graph on the card
    (`graphs.Graph`), the stage loop itself on the CPU.

    Arguments are tensors (copied into static input buffers before a
    replay) and floats (written into one-element fp32 device buffers, so
    the graph reads the new value).  On the card, the first call is the
    warm-up: it runs the stage loop on a side stream — this call's own
    result, so a training step is applied exactly once — and then captures
    the loop into a graph, which later calls replay.  A capture that fails
    raises; nothing falls back to running the loop.  A call with
    ``repeat=n`` binds its arguments once and runs the program ``n`` times
    on them (a body that advances state held in its own inputs, such as a
    serving beat)."""

    def __init__(self, body: Callable, args: list):
        self.body = body
        self.device = next(a.device for a in args
                           if isinstance(a, torch.Tensor))
        self.graph = graphs.Graph(body, self.device)
        self.inputs: list[torch.Tensor] = []

    @property
    def per_replay(self) -> dict[str, int]:
        """Each wrapper's launches in one replay (empty before capture)."""
        return self.graph.per_replay

    def _bind(self, args: list) -> list[torch.Tensor]:
        if self.device.type == "cpu":
            return [a if isinstance(a, torch.Tensor)
                    else torch.full((1,), a, dtype=torch.float32)
                    for a in args]
        if not self.inputs:
            self.inputs = [torch.empty_like(a) if isinstance(a, torch.Tensor)
                           else torch.empty(1, dtype=torch.float32,
                                            device=self.device)
                           for a in args]
        for buf, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
            else:
                buf.fill_(a)    # double -> fp32, rounded once
        return self.inputs

    def __call__(self, args: list, repeat: int = 1):
        inputs = self._bind(args)
        if self.device.type == "cpu":
            for _ in range(repeat):
                result = self.body(*inputs)
            return result
        if not self.graph.captured:
            result = self.graph.warm_up(*inputs)
            self.graph.capture(*inputs)
            repeat -= 1
            if not repeat:
                return result
        for _ in range(repeat):
            result = self.graph.replay()
        return graphs.clone_tree(result)


def _run(stacks: StageStacks, key: tuple, body: Callable, args: list,
         repeat: int = 1):
    """Run program ``key`` on ``stacks``, building it at its first use."""
    prog = stacks.programs.get(key)
    if prog is None:
        prog = stacks.programs[key] = _Program(body, args)
        _CAPTURES[key] += 1
    return prog(args, repeat)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _chipped(stacks: StageStacks, x: torch.Tensor) -> bool:
    """Whether ``x`` carries a leading chip axis (a farm's (C, M, fan_in)
    batch) or not (a chip's (M, fan_in)); it must match the envelope."""
    chipped = x.dim() == 3
    if (x.shape[0] if chipped else 1) != stacks.chips:
        raise ValueError(f"batch {tuple(x.shape)} does not match an envelope "
                         f"of {stacks.chips} chips")
    return chipped


def chip_forward(stacks: StageStacks, x: torch.Tensor, quantize_tail: bool,
                 cfg: ChipConfig):
    """Compiled wave of a chip: (embedded stage inputs [(M, 1 + fan_in)],
    dot products [(M, fan_out)], tail activation (M, out_dim), counters
    [fwd_slots, fwd_core_steps]).  ``quantize_tail`` ADC-quantizes the
    tail (a chip slice whose output crosses a link); it is part of the
    program's key."""
    _chipped(stacks, x)

    def body(x):
        _, acts, dps, h, cnt = _forward_scan(stacks, x[None], quantize_tail,
                                             cfg)
        return [a[0] for a in acts], [d[0] for d in dps], h[0], cnt
    return _run(stacks, ("chip_forward", cfg, tuple(x.shape),
                         bool(quantize_tail)), body, [x])


def chip_infer(stacks: StageStacks, x: torch.Tensor, cfg: ChipConfig):
    """Compiled recognition wave -> (out, counters per chip).  ``x`` is a
    chip's (M, fan_in) -> out (M, out_dim), or a farm's chip-stacked
    (C, M, fan_in) -> (C, M, out_dim)."""
    chipped = _chipped(stacks, x)

    def body(x):
        _, _, dps, _, cnt = _forward_scan(stacks, x if chipped else x[None],
                                          False, cfg)
        out = hard_sigmoid(dps[-1])
        return (out if chipped else out[0]), cnt
    return _run(stacks, ("chip_infer", cfg, tuple(x.shape)), body, [x])


def chip_train(stacks: StageStacks, x: torch.Tensor, target: torch.Tensor,
               cfg: ChipConfig, lr_eff: float, reconcile: str | None = None):
    """Compiled training step — forward wave, then the reversed backward /
    update loop, the envelope updated in place.  Returns (err = target -
    out, fwd counters, bwd counters), counters per chip.  ``lr_eff`` (lr /
    global batch) is written into the program's device buffer: a new value
    replays the same program.  A chip's ``x`` is (M, fan_in); a farm's is
    chip-stacked (C, M, fan_in) and takes ``reconcile`` ("none" or "int8",
    `dist.collectives.farm_reduce_sum`)."""
    chipped = _chipped(stacks, x)
    if chipped == (reconcile is None):
        raise ValueError("a farm step reconciles (reconcile='none' or "
                         "'int8'); a chip step does not")

    def body(x, target, lr):
        if not chipped:
            x, target = x[None], target[None]
        xs_all, _, dps, _, fcnt = _forward_scan(stacks, x, False, cfg)
        delta0 = target - hard_sigmoid(dps[-1])
        _, bcnt = _backward_scan(stacks, xs_all, dps, delta0, lr, cfg,
                                 reconcile)
        return (delta0 if chipped else delta0[0]), fcnt, bcnt
    key = ("chip_train", cfg, tuple(x.shape)) + ((reconcile,) if chipped
                                                  else ())
    return _run(stacks, key, body, [x, target, float(lr_eff)])


def chip_backward(stacks: StageStacks, acts: list[torch.Tensor],
                  dps: list[torch.Tensor], delta: torch.Tensor,
                  cfg: ChipConfig, lr_eff: float):
    """Compiled backward + update phases of a chip (the pipeline fabric's
    per-chip entry point): ``acts`` are the stage inputs (M, fan_in),
    ``dps`` the dot products (M, fan_out) and ``delta`` the error at the
    output side (M, out_dim).  Returns (error at the input side
    (M, fan_in[0]), counters)."""
    S = cfg.S
    _chipped(stacks, delta)

    def body(*flat):
        acts_, dps_, delta_, lr = flat[:S], flat[S:2 * S], flat[-2], flat[-1]
        xs_all = [_gather_cores(_embed(a[None]), m.in_idx, m.T)
                  for a, m in zip(acts_, stacks.stage_maps)]
        dfin, cnt = _backward_scan(stacks, xs_all, [d[None] for d in dps_],
                                   delta_[None], lr, cfg)
        return dfin[0], cnt
    return _run(stacks, ("chip_backward", cfg, tuple(delta.shape)), body,
                [*acts, *dps, delta, float(lr_eff)])


# ---------------------------------------------------------------------------
# Serving beat loop (the farm's front-end; the pipeline's next)
# ---------------------------------------------------------------------------

def _serve_maps(stacks: StageStacks) -> tuple[torch.Tensor, torch.Tensor]:
    """Index maps of a serving beat over every stage's own cores
    concatenated (sumT = sum of T_s cores, stage-major, no padding):

      * ``in_cat`` (sumT*rows,): core line -> lane of the (S*L) wavefront
        slab (stage ``s``'s slot starts at ``s*L``; 0 offsets hit the
        stage's always-zero bias lane);
      * ``dp_cat`` (r_max, S*N_pad): dot-product lane -> output of the
        (sumT*cols + 1) flattened core outputs, the last one an appended
        zero (fan-in tiles a stage does not have, lanes past its
        fan-out)."""
    maps = stacks.stage_maps
    offs = [0]
    for m in maps[:-1]:
        offs.append(offs[-1] + m.T)
    zero = (offs[-1] + maps[-1].T) * stacks.cols
    in_cat = torch.cat([s * stacks.L + m.in_idx for s, m in enumerate(maps)])
    dp_cat = torch.full((stacks.r_max, stacks.S * stacks.N_pad), zero,
                        dtype=torch.int64, device=in_cat.device)
    for s, (m, off) in enumerate(zip(maps, offs)):
        lo = s * stacks.N_pad
        dp_cat[:m.r, lo:lo + m.fan_out] = off * stacks.cols + m.dp_idx
    return in_cat, dp_cat


def _beat(requests, gp_cat, gm_cat, in_cat, dp_cat, H, out, b, *,
          cfg: ChipConfig):
    """One pipeline beat of every lane, state held in its inputs: the
    wavefront slab ``H`` (C, m, S, L), the results ``out`` (Qp, m,
    out_dim) and the beat index ``b`` (1,) int64.  Request ``r`` enters
    lane ``r % C`` at beat ``r // C`` and retires ``S - 1`` beats later.
    ONE forward launch evaluates every (lane, stage) core; the Fig.-14
    aggregation is a gather-sum through ``dp_cat``."""
    Qp, m, D = requests.shape
    C, S = H.shape[0], cfg.S
    lanes = torch.arange(C, device=H.device)
    first = torch.clamp(b * C, max=Qp - C)
    H[:, :, 0, 1:D + 1] = requests.index_select(0, first + lanes)
    xs = (H.reshape(C, m, -1).index_select(2, in_cat)
          .reshape(C, m, -1, cfg.rows).transpose(1, 2).contiguous())
    ys = kernel_ops.crossbar_fwd_stacked(xs, gp_cat, gm_cat)
    ys_flat = torch.nn.functional.pad(
        ys.transpose(1, 2).reshape(C, m, -1), (0, 1))
    dp = ys_flat.index_select(2, dp_cat[0])
    for i in range(1, cfg.r_max):
        dp = dp + ys_flat.index_select(2, dp_cat[i])
    h = hard_sigmoid(dp).reshape(C, m, S, cfg.N_pad)
    if cfg.transport_quant and S > 1:
        h = torch.cat([q.adc_quantize(h[:, :, :S - 1], cfg.adc_bits),
                       h[:, :, S - 1:]], dim=2)
    row = torch.clamp((b - (S - 1)) * C, min=0, max=Qp - C)
    out.index_copy_(0, row + lanes, h[:, :, S - 1, :cfg.out_dim])
    H[:, :, 1:, 1:] = h[:, :, :S - 1]
    b += 1
    return out


def serve_session_applicable(queue, slots_empty: bool,
                             slot_m: int | None = None) -> bool:
    """Whether a serving session can run as one compiled beat program: a
    fresh (empty-pipe) server draining a queue of uniform-shape requests
    that also match the server's established request microbatch
    (``slot_m``).  Anything else — step-wise use, beat limits, ragged
    shapes, a cross-session microbatch change — stays on the eager path,
    which enforces the uniform-shape contract with the same errors either
    way."""
    if not slots_empty or not queue.pending:
        return False
    shapes = {_request_shape(r.x) for r in queue.pending}
    if len(shapes) != 1:
        return False
    return slot_m is None or next(iter(shapes))[0] == slot_m


def _request_shape(x) -> tuple[int, int]:
    """(m, features) of one request's input, a row or an (m, features)
    batch."""
    shape = tuple(x.shape)
    return shape if len(shape) == 2 else (1,) + shape


def run_serve_session(queue, stacks: StageStacks, gp_cat: torch.Tensor,
                      gm_cat: torch.Tensor, spec,
                      n_lanes: int) -> tuple[int, int, int, int]:
    """Drain ``queue`` through the compiled beat program (the shared
    front-end driver of the farm's server): request ``r`` enters lane
    ``r % n_lanes`` at beat ``r // n_lanes`` — the eager wavefront's
    static schedule.  ``gp_cat``/``gm_cat`` are the lanes' stage cores
    concatenated, (n_lanes, sumT, rows, cols).  Completes every request in
    order and returns (requests, microbatch m, q_max, beats); the callers
    replay their own counter/link billing from the same schedule.

    On the card one beat is captured as a CUDA graph (its beat index a
    device buffer the beat itself advances) and replayed ``S - 1 + q_pad``
    times: one graph per (lanes, m, Qp), whatever the queue's length."""
    reqs = []
    while True:
        r = queue.pop()
        if r is None:
            break
        reqs.append(r)
    device = gp_cat.device
    xs = [torch.atleast_2d(torch.as_tensor(r.x, dtype=torch.float32,
                                           device=device)) for r in reqs]
    Q, (m, D) = len(reqs), xs[0].shape
    q_max = -(-Q // n_lanes)
    # bucket the lane depth to a power of two so varying queue lengths
    # share built programs (the beat's shapes are static in Qp).  The
    # spare beats re-inject the final padded block, whose never-retired
    # junk lands — clamped — only in rows >= q_max*n_lanes >= Q, all
    # sliced away below; the REAL schedule (and therefore the billing the
    # callers replay) is unchanged, so the returned q_max/beats stay the
    # eager loop's.
    q_pad = 1 << (q_max - 1).bit_length()
    Qp = q_pad * n_lanes
    requests = torch.zeros((Qp, m, D), dtype=torch.float32, device=device)
    requests[:Q] = torch.stack(xs)
    cfg = chip_config(stacks, spec)
    in_cat, dp_cat = _serve_maps(stacks)
    state = [torch.zeros((n_lanes, m, cfg.S, cfg.L), dtype=torch.float32,
                         device=device),
             torch.zeros((Qp, m, cfg.out_dim), dtype=torch.float32,
                         device=device),
             torch.zeros(1, dtype=torch.int64, device=device)]

    def body(*args):
        return _beat(*args, cfg=cfg)
    out = _run(stacks, ("serve_scan", cfg, tuple(requests.shape),
                        tuple(gp_cat.shape)), body,
               [requests, gp_cat, gm_cat, in_cat, dp_cat, *state],
               repeat=cfg.S - 1 + q_pad)
    for i, r in enumerate(reqs):
        queue.complete(r.rid, out[i])
    return Q, m, q_max, cfg.S - 1 + q_max
