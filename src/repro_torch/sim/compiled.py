"""Compiled whole-step execution for the virtual chip (port of
``repro.sim.compiled``).

The eager simulator drives every stage from Python: a dozen small
PyTorch operations and one or two kernel launches per stage per phase,
each enqueued by the host while the device waits.  The paper's chip has
no host in the loop: the whole network step is a fixed schedule.  This
module is that schedule for the simulator.  The recognition wave and the
training step (forward wave + reversed backward/update loop) each run as
ONE program per (topology, batch):

  * on the card, a captured ``torch.cuda.CUDAGraph``: the stage loop runs
    once under capture and every later call replays it, so the host
    enqueues one graph launch instead of every operation;
  * on the CPU, the same stage loop, run on every call (one built program
    per key, counted the same way).

The stage loop (the reference's ``lax.scan``) walks the padded
`placer.StageStacks`, but each stage launches on its own ``T_s`` cores —
the view ``envelope[s, :T_s]`` — and indexes with its own slice of the
maps (`placer.StageMaps`), so no launch shape and no sum depends on the
envelope: a stage computes the same bits inside any envelope, which is
what the pipeline fabric's slice-versus-serial pins rest on.  The
reference's padded terms (trailing zero cores, zero lanes, zero fan-in
tiles) are exact zeros, so skipping them changes no value.

  * The Fig.-14 aggregation is a gather and a sequential sum over the
    stage's fan-in tiles (no aggregation-core launch): a wave launches
    ``crossbar_fwd`` once per stage.
  * The training body is the fused kernel
    (`kernels/ops.crossbar_train_stacked`), whose new conductances are
    copied into the envelope in place: a step launches ``crossbar_fwd``
    and ``crossbar_train`` once per stage, and the envelope keeps its
    memory (the port's form of the reference's buffer donation).
  * ``lr_eff = lr / B`` lives in a one-element fp32 device buffer written
    before each call, so an lr schedule replays the same graph.
  * Counters are the reference's ``[fwd_slots, fwd_core_steps]`` and
    ``[b_slots, b_steps, u_slots, u_steps]``.  They depend on shapes only,
    so the stage loop counts them on the host when it runs and a replay
    returns the same numbers: no device read at all.
  * Launch counts: under capture the wrappers' ``launches`` tick without
    anything running, so a capture records each graph's launches, takes
    them back, and adds them on every replay — ``launches`` keeps
    counting launches executed.

In place of ``trace_counts`` the module counts built programs per
(program, config, shapes) (`capture_counts`).  A captured graph bakes in
the envelope's addresses, so programs live on the `StageStacks` they were
built for: two chips of one topology build one program each.

Not ported yet: the farm's data-parallel branch of the backward loop
(``reconcile in ("none", "int8")``) and the serving beat loop
(``serve_scan``, ``run_serve_session``), with the farm and pipeline
slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, NamedTuple

import torch

from repro_torch.core import quantization as q
from repro_torch.core.crossbar import hard_sigmoid, hard_sigmoid_deriv
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ops as _wrappers   # counts; see _launch_counts
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
# The stage loop
# ---------------------------------------------------------------------------

def _embed(h: torch.Tensor) -> torch.Tensor:
    """(M, W) activation -> (M, 1 + W) input vector: the always-zero bias
    slot 0, then the payload."""
    return torch.nn.functional.pad(h, (1, 0))


def _gather_cores(v: torch.Tensor, idx: torch.Tensor,
                  T: int) -> torch.Tensor:
    """(M, lanes) values -> (T, M, width) per-core slabs through a flat
    (T*width,) index map."""
    M = v.shape[0]
    return (v.index_select(1, idx).reshape(M, T, -1).transpose(0, 1)
             .contiguous())


def _envelope(stacks: StageStacks, s: int, m: StageMaps):
    """Stage ``s``'s own cores: contiguous views of the envelope."""
    return stacks.g_plus[s, :m.T], stacks.g_minus[s, :m.T]


def _stage_dp(h_ext: torch.Tensor, stacks: StageStacks, s: int,
              m: StageMaps) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage's core inputs ``xs`` (T, M, rows) and exact-aggregated dot
    products (M, fan_out): one forward launch, then the Fig.-14
    aggregation as a sequential sum over the fan-in tiles."""
    xs = _gather_cores(h_ext, m.in_idx, m.T)
    ys = kernel_ops.crossbar_fwd_stacked(xs, *_envelope(stacks, s, m))
    ys_flat = ys.transpose(0, 1).reshape(xs.shape[1], -1)
    dp = ys_flat.index_select(1, m.dp_idx[0])
    for i in range(1, m.r):
        dp = dp + ys_flat.index_select(1, m.dp_idx[i])
    return xs, dp


def _forward_scan(stacks: StageStacks, x: torch.Tensor, quantize_tail: bool,
                  cfg: ChipConfig):
    """Wave through all stages.  Returns (core inputs per stage, embedded
    stage inputs (M, 1 + fan_in), dot products (M, fan_out), tail
    activation, counters [fwd_slots, fwd_core_steps])."""
    M = x.shape[0]
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
                   lr_eff: torch.Tensor, cfg: ChipConfig):
    """Backward + update phases over the stages in reverse, the envelope
    updated in place.  Returns (error at the first stage's input,
    counters [b_slots, b_steps, u_slots, u_steps])."""
    M = delta.shape[0]
    cnt = [0, 0, 0, 0]
    for s in reversed(range(cfg.S)):
        m = stacks.stage_maps[s]
        gp_s, gm_s = _envelope(stacks, s, m)
        if cfg.error_quant:
            # III.F step 1: errors ride the links as 8-bit codes
            delta = q.error_quantize(delta, cfg.err_bits).dequantize()
        local = delta * hard_sigmoid_deriv(dps[s])
        ds = _gather_cores(torch.nn.functional.pad(local, (0, 1)),
                           m.ds_idx, m.T)                 # (T, M, cols)
        if cfg.update_quant:
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
        dxg = dxs.index_select(0, m.fold_idx[:, 0])
        for j in range(1, m.c):
            dxg = dxg + dxs.index_select(0, m.fold_idx[:, j])
        dxg_flat = dxg.transpose(0, 1).reshape(M, -1)     # (M, r*rows)
        delta = dxg_flat.index_select(1, m.prev_idx)      # strip bias line
        cnt = [cnt[0] + M, cnt[1] + M * m.cores, cnt[2] + M,
               cnt[3] + M * m.cores]
    return delta, cnt


# ---------------------------------------------------------------------------
# Programs: one per (program, config, shapes) on a StageStacks
# ---------------------------------------------------------------------------

def _launch_counts() -> dict[str, int]:
    """Every wrapper's ``launches``, read from the ops module itself (not
    through ``kernel_ops``, which a caller may wrap to record calls)."""
    return {name: fn.launches for name, fn in vars(_wrappers).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}


def _clone(tree):
    """Copy the tensors of a (nested) result out of a graph's memory."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(t) for t in tree)
    return tree


class _Program:
    """One built program: a captured CUDA graph on the card, the stage loop
    itself on the CPU.

    Arguments are tensors (copied into static input buffers before a
    replay) and floats (written into one-element fp32 device buffers, so
    the graph reads the new value).  On the card, the first call is the
    warm-up: it runs the stage loop on a side stream — this call's own
    result, so a training step is applied exactly once — and then captures
    the loop into a graph, which later calls replay.  A capture that fails
    raises; nothing falls back to running the loop."""

    def __init__(self, body: Callable, args: list):
        self.body = body
        self.device = next(a.device for a in args
                           if isinstance(a, torch.Tensor))
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: list[torch.Tensor] = []
        self.result = None
        self.per_replay: dict[str, int] = {}

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

    def __call__(self, args: list):
        inputs = self._bind(args)
        if self.device.type == "cpu":
            return self.body(*inputs)
        if self.graph is None:
            return self._warm_up_and_capture(inputs)
        self.graph.replay()
        for name, n in self.per_replay.items():
            getattr(_wrappers, name).launches += n
        return _clone(self.result)

    def _warm_up_and_capture(self, inputs: list[torch.Tensor]):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.body(*inputs)
        current.wait_stream(side)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.result = self.body(*inputs)
        after = _launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        for name, n in before.items():      # a capture launches nothing
            getattr(_wrappers, name).launches = n
        self.graph = graph
        return result


def _run(stacks: StageStacks, key: tuple, body: Callable, args: list):
    """Run program ``key`` on ``stacks``, building it at its first use."""
    prog = stacks.programs.get(key)
    if prog is None:
        prog = stacks.programs[key] = _Program(body, args)
        _CAPTURES[key] += 1
    return prog(args)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def chip_forward(stacks: StageStacks, x: torch.Tensor, quantize_tail: bool,
                 cfg: ChipConfig):
    """Compiled wave: (embedded stage inputs [(M, 1 + fan_in)], dot
    products [(M, fan_out)], tail activation (M, out_dim), counters
    [fwd_slots, fwd_core_steps]).  ``quantize_tail`` ADC-quantizes the
    tail (a chip slice whose output crosses a link); it is part of the
    program's key."""
    def body(x):
        _, acts, dps, h, cnt = _forward_scan(stacks, x, quantize_tail, cfg)
        return acts, dps, h, cnt
    return _run(stacks, ("chip_forward", cfg, tuple(x.shape),
                         bool(quantize_tail)), body, [x])


def chip_infer(stacks: StageStacks, x: torch.Tensor, cfg: ChipConfig):
    """Compiled recognition wave -> (out (M, out_dim), counters)."""
    def body(x):
        _, _, dps, _, cnt = _forward_scan(stacks, x, False, cfg)
        return hard_sigmoid(dps[-1]), cnt
    return _run(stacks, ("chip_infer", cfg, tuple(x.shape)), body, [x])


def chip_train(stacks: StageStacks, x: torch.Tensor, target: torch.Tensor,
               cfg: ChipConfig, lr_eff: float):
    """Compiled training step — forward wave, then the reversed backward /
    update loop, the envelope updated in place.  Returns (err = target -
    out, fwd counters, bwd counters).  ``lr_eff`` (lr / batch) is written
    into the program's device buffer: a new value replays the same
    program."""
    def body(x, target, lr):
        xs_all, _, dps, _, fcnt = _forward_scan(stacks, x, False, cfg)
        delta0 = target - hard_sigmoid(dps[-1])
        _, bcnt = _backward_scan(stacks, xs_all, dps, delta0, lr, cfg)
        return delta0, fcnt, bcnt
    return _run(stacks, ("chip_train", cfg, tuple(x.shape)), body,
                [x, target, float(lr_eff)])


def chip_backward(stacks: StageStacks, acts: list[torch.Tensor],
                  dps: list[torch.Tensor], delta: torch.Tensor,
                  cfg: ChipConfig, lr_eff: float):
    """Compiled backward + update phases (the pipeline fabric's per-chip
    entry point): ``acts`` are the stage inputs (M, fan_in), ``dps`` the
    dot products (M, fan_out) and ``delta`` the error at the output side
    (M, out_dim).  Returns (error at the input side (M, fan_in[0]),
    counters)."""
    S = cfg.S

    def body(*flat):
        acts_, dps_, delta_, lr = flat[:S], flat[S:2 * S], flat[-2], flat[-1]
        xs_all = [_gather_cores(_embed(a), m.in_idx, m.T)
                  for a, m in zip(acts_, stacks.stage_maps)]
        return _backward_scan(stacks, xs_all, list(dps_), delta_, lr, cfg)
    return _run(stacks, ("chip_backward", cfg, tuple(delta.shape)), body,
                [*acts, *dps, delta, float(lr_eff)])
