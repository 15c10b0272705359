#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them, and
when run from a directory that does not hold the repository's ``src/``.
Imports nothing of JAX or of the JAX package.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for every fp32 matmul and convolution;
2. builds the four crossbar kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints the build time
   and ptxas' register/spill report;
3. kernel phase: holds each CUDA kernel against its plain PyTorch version
   on the card — the forward at every mnist_class and isolet_class
   recognition stage shape (M = 16 and 4096), a ragged shape, a chip-axis
   (4-D) case and the fused activation + 3-bit ADC epilogue; the error
   backprop, weight gradient and pulse update at every training stage
   stack (M = 1, 64 and 4096), a ragged shape (K = 300, N = 26), a
   chip-axis case and the int8 error-code path of bwd and dw — and times
   each kernel, its plain version and ``torch.bmm`` for the same
   contraction at M = 4096 beside the bound;
4. recognition path: ``build_chip("mnist_class")`` at full width
   (784-300-200-100-10, 13 cores) runs ``infer_stream`` on 16 samples and
   on a 4096-sample wave, then ``build_chip("isolet_class")`` (160 cores)
   one 256-sample wave, with the forward kernel's launch count set to 0
   before and read after (5 launches per mnist wave, 9 per isolet wave).
   Outputs are held against the port's plain ``mlp_forward`` and, stage by
   stage, against the plain product on the chip's own stage inputs;
   ``mlp_forward(use_kernel=True)`` against its plain version; the counters
   against ``hw_model`` within 1 % and the beat against Table IV's 0.77 us;
5. training path: with every count set to 0, mnist_class takes 3
   ``train_step``s at batch 1 and 2 at batch 4096, and isolet_class one at
   batch 256.  Each stage's backward phase must be one bwd launch and its
   update one pulse launch (4 + 4 per mnist step, 5 + 5 per isolet step);
   every stage's dx and new conductances are held against the plain
   versions on the chip's own stage inputs, each whole step against the
   port's plain ``paper_backprop_step`` on the same layers and data, and
   ``compare_hw`` within 1 % on all six keys;
6. ``crossbar_apply(use_kernel=True)`` path: the gradients of a
   squared-error loss through mnist's four layers at M = 64 and 4096, with
   8-bit error quantization, through ``crossbar_matmul`` (one bwd and one
   dw launch per layer), held layer by layer against the plain
   ``_xbar_matmul`` path on the same inputs;
7. prints the wave and training-step times (CUDA events), a
   ``torch.profiler`` breakdown of one mnist wave, one
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.

Tolerances: fp32 values agree within 1e-5 absolute plus 1e-5 relative (the
repo's kernel bar; the two sides sum in different orders).  Quantized
activations are compared as 3-bit codes; a code may differ only where the
value before the ADC lies within 1e-6 of a half-step boundary — and then
only the samples downstream of such a flip may differ end to end.  Pulse
counts may differ by one only where the plain unrounded count lies within
1e-4 of a half-integer; there a conductance may differ by one half pulse
(u/2 = 1.95e-4), everywhere else by at most 1e-6.  Any failure raises.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402

ATOL = 1e-5              # fp32 agreement, kernel vs plain (summation order)
BOUNDARY = 1e-6          # ADC code flips allowed only this close to a boundary
PULSE_BOUNDARY = 1e-4    # pulse-count flips allowed only this close to k + 1/2
G_ATOL = 1e-6            # conductances away from a pulse boundary
ADC_BITS, ADC_RANGE = 3, 0.5
MAX_DW, LEVELS, W_MAX = 0.05, 128, 1.0   # PAPER_SPEC's pulse rule
LR = 0.1                 # the CLI's default learning rate
FP32_FLOPS = 67e12       # H100 SXM fp32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3 bandwidth
SEED = 0

# Stage shapes (T cores, K fan-in lines, N columns) of one recognition wave,
# one entry per launch, in launch order (core/mapping.map_network, 400x100).
WAVE_SHAPES = {
    "mnist_class": [(6, 400, 100), (3, 200, 100), (2, 400, 100),
                    (1, 400, 100), (1, 400, 100)],
    "isolet_class": [(40, 400, 100), (20, 200, 100), (60, 400, 100),
                     (10, 600, 100), (15, 400, 100), (5, 300, 100),
                     (6, 400, 100), (3, 200, 100), (1, 400, 100)],
}
# Stage stacks (T, K, N) of one training step, in layer order: each is one
# bwd and one pulse launch (the aggregation cores take no part).
TRAIN_SHAPES = {
    "mnist_class": [(6, 400, 100), (2, 400, 100), (1, 400, 100),
                    (1, 400, 100)],
    "isolet_class": [(40, 400, 100), (60, 400, 100), (15, 400, 100),
                     (6, 400, 100), (1, 400, 100)],
}
# (K, N) of mnist's four layers: crossbar_apply(use_kernel=True) shapes
MNIST_LAYERS = [(784, 300), (300, 200), (200, 100), (100, 10)]
KERNELS = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def uniform(shape, lo, hi, gen) -> torch.Tensor:
    """Uniform [lo, hi) fp32 on the card, drawn from the CUDA generator."""
    return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(T, M, K, N, kernel: str = "crossbar_fwd",
          dy_bytes: int = 4) -> tuple[float, float]:
    """(ms at the fp32 rate, ms at the HBM rate) for one launch: each input
    byte read once and each output byte written once.  ``dy_bytes`` is the
    size of one error element (1 for int8 codes)."""
    if kernel in ("crossbar_fwd", "crossbar_bwd"):
        flops = 2.0 * T * M * K * N + T * K * N    # products + delta
        act = M * K * 4 + M * N * (dy_bytes if kernel == "crossbar_bwd"
                                   else 4)
        nbytes = T * (act + 2 * K * N * 4)
    elif kernel == "crossbar_dw":
        flops = 2.0 * T * M * K * N
        nbytes = T * (M * K * 4 + M * N * dy_bytes + K * N * 4)
    else:   # pulse_update: product + a 10-operation epilogue per cell
        flops = 2.0 * T * M * K * N + 10.0 * T * K * N
        nbytes = 4.0 * T * (M * K + M * N + 4 * K * N)
    return flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3


def close(got: torch.Tensor, want: torch.Tensor, what) -> float:
    """Raise unless |got - want| <= ATOL + ATOL |want| everywhere; returns
    the largest absolute difference."""
    err = (got - want).abs()
    if not bool((err <= ATOL + ATOL * want.abs()).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def near_half(counts: torch.Tensor) -> torch.Tensor:
    """Cells whose unrounded pulse count lies within PULSE_BOUNDARY of a
    half-integer, where a last-bit difference rounds the other way."""
    return (counts - torch.floor(counts) - 0.5).abs() < PULSE_BOUNDARY


def check_conductances(got, want, counts, what) -> int:
    """Hold new conductances (g+, g-) against the plain ones: within G_ATOL,
    except cells next to a pulse boundary of the plain unrounded ``counts``,
    which may differ by one half pulse.  Returns the cells that differ."""
    near = near_half(counts)
    half_u = 0.5 * MAX_DW / LEVELS
    flipped = torch.zeros_like(near)
    for g, w in zip(got, want):
        d = (g - w).abs()
        if bool((d[~near] > G_ATOL).any()) or \
                bool((d[near] > half_u + G_ATOL).any()):
            raise AssertionError(
                f"{what}: conductances differ by {float(d.max())} "
                f"({int((d > G_ATOL).sum())} cells, "
                f"{int(((d > G_ATOL) & ~near).sum())} off a pulse boundary)")
        flipped |= d > G_ATOL
    return int(flipped.sum())


def check_pulse_counts(gp, gm, got, want, counts, what) -> int:
    """Pulse counts as integers, read back from unclipped conductances:
    equal, or one apart where the plain count is next to a half-integer.
    Returns the number of flipped counts."""
    half_u = 0.5 * MAX_DW / LEVELS
    near = near_half(counts)
    n_flip = 0
    for g, new, ref in ((gp, got[0], want[0]), (gm, got[1], want[1])):
        kc = torch.round((new - g) / half_u)
        pc = torch.round((ref - g) / half_u)
        diff = (kc - pc).abs()
        if bool((diff > 1).any()) or bool(((diff > 0) & ~near).any()):
            raise AssertionError(f"{what}: {int((diff > 0).sum())} pulse "
                                 f"counts differ, max by {float(diff.max())}")
        n_flip += int((diff > 0).sum())
    check_conductances(got, want, counts, what)
    return n_flip


def code_flips(pre: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """Per-sample flags of 3-bit ADC codes of ``got`` that differ from the
    codes of the reference value ``pre`` (taken before the ADC).  Raises if
    a code differs where ``pre`` is not within BOUNDARY of a half-step
    boundary."""
    scale = 2.0 * ADC_RANGE / (2 ** ADC_BITS - 1)
    u = (pre.clamp(-ADC_RANGE, ADC_RANGE) + ADC_RANGE) / scale
    flip = torch.round(u) != torch.round((got + ADC_RANGE) / scale)
    dist = (u - torch.floor(u) - 0.5).abs() * scale
    bad = flip & (dist > BOUNDARY)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ADC codes differ away from "
                             f"a rounding boundary")
    return flip.reshape(-1, flip.shape[-1]).any(dim=-1)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(xbk, ops, gen) -> tuple[float, list[dict]]:
    """Kernel vs plain version on the card; returns (max |err|, timing rows
    at the M = 4096 wave shapes)."""
    cases = []
    for app, shapes in WAVE_SHAPES.items():
        for M in (16, 4096):
            cases += [dict(app=app, shape=(T, M, K, N))
                      for T, K, N in dict.fromkeys(shapes)]
    cases += [dict(app="ragged", shape=(5, 3, 37, 11)),
              dict(app="chip-axis", shape=(3, 7, 45, 13), chips=2),
              dict(app="epilogue", shape=(6, 16, 400, 100), activation=True,
                   adc_bits=ADC_BITS),
              dict(app="epilogue", shape=(1, 4096, 784, 300),
                   activation=True, adc_bits=ADC_BITS)]
    max_err, rows, flips = 0.0, [], 0
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        act, bits = case.get("activation", False), case.get("adc_bits")
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        gp = uniform(lead + (T, K, N), 0.0, 0.02, gen)
        gm = uniform(lead + (T, K, N), 0.0, 0.02, gen)
        if lead:
            y = ops.crossbar_fwd_stacked(xs, gp, gm, activation=act,
                                         adc_bits=bits)
            y, xs, gp, gm = (a.reshape((-1,) + a.shape[2:])
                             for a in (y, xs, gp, gm))
        else:
            y = xbk.crossbar_fwd_kernel(xs, gp, gm, activation=act,
                                        adc_bits=bits)
        ref = xbk.crossbar_fwd_plain(xs, gp, gm, activation=act,
                                     adc_bits=bits)
        torch.cuda.synchronize()
        keep = torch.ones_like(y, dtype=torch.bool)
        if bits is not None:
            pre = xbk.crossbar_fwd_plain(xs, gp, gm, activation=act)
            scale = 2.0 * ADC_RANGE / (2 ** bits - 1)
            code_flips(pre, y)
            keep = (torch.round((y + ADC_RANGE) / scale)
                    == torch.round((ref + ADC_RANGE) / scale))
            flips += int((~keep).sum())
        err = float((y - ref).abs()[keep].max())
        if not err <= ATOL:
            raise AssertionError(f"kernel vs plain {case}: max |err| {err}")
        max_err = max(max_err, err)
        if M == 4096 and case["app"] in WAVE_SHAPES:
            rows.append(time_shape(xbk, case["app"], xs, gp, gm))
    print(f"kernel phase: {len(cases)} cases, max |kernel - plain| "
          f"{max_err:.3e} (atol {ATOL}), {flips} ADC code flips at "
          f"boundaries")
    return max_err, rows


def time_shape(xbk, app, xs, gp, gm) -> dict:
    T, M, K = xs.shape
    N = gp.shape[2]
    return time_row("crossbar_fwd", T, M, K, N, {
        "ms": lambda: xbk.crossbar_fwd_kernel(xs, gp, gm, activation=False),
        "plain_ms": lambda: xbk.crossbar_fwd_plain(xs, gp, gm,
                                                   activation=False),
        "library_ms": lambda: torch.bmm(xs, gp - gm),
    }, app=app)


def train_kernel_cases() -> list[dict]:
    """Training-kernel cases: every stage stack at M = 1, 64, 4096; a
    ragged shape; a chip axis; the int8 error-code path."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [dict(shape=(T, M, K, N)) for T, K, N in stacks
             for M in (1, 64, 4096)]
    cases += [dict(shape=(3, 37, 300, 26)),
              dict(shape=(3, 7, 45, 13), chips=2),
              dict(shape=(6, 4096, 400, 100), codes=True),
              dict(shape=(3, 37, 300, 26), codes=True),
              dict(shape=(3, 7, 45, 13), chips=2, codes=True)]
    return cases


def train_kernel_phase(xbk, ops, gen) -> tuple[dict, list[dict]]:
    """bwd, dw and pulse kernels vs their plain versions on the card;
    returns ({kernel: max |err|}, timing rows at M = 4096)."""
    max_err = {k: 0.0 for k in KERNELS[1:]}
    rows, flips = [], 0
    cases = train_kernel_cases()
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        ds = uniform(lead + (T, M, N), -0.05, 0.05, gen)
        # mid-range conductances: no pulse clips, so counts read back
        gp = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        gm = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        scale = None
        dys = ds
        if case.get("codes"):
            dys = torch.randint(-127, 128, lead + (T, M, N), generator=gen,
                                dtype=torch.int8, device="cuda")
            scale = torch.tensor(0.05 / 127, device="cuda")
        lr = 0.25 / M ** 0.5         # spreads counts over several levels
        rule = dict(lr=lr, max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
        if lead:   # through the stacked wrappers' chip-axis fold
            dx = ops.crossbar_bwd_stacked(dys, gp, gm, dy_scale=scale)
            dw = ops.crossbar_dw_stacked(xs, dys, dy_scale=scale)
            new = ops.pulse_update_stacked(gp, gm, xs, ds, **rule)
            dx, dw, dys, xs, ds, gp, gm = (
                a.reshape((-1,) + a.shape[2:])
                for a in (dx, dw, dys, xs, ds, gp, gm))
            new = tuple(a.reshape((-1,) + a.shape[2:]) for a in new)
        else:
            dx = xbk.crossbar_bwd_kernel(dys, gp, gm, dy_scale=scale)
            dw = xbk.crossbar_dw_kernel(xs, dys, dy_scale=scale)
            new = xbk.pulse_update_kernel(gp, gm, xs, ds, **rule)
        torch.cuda.synchronize()
        what = f"{case} lr={lr:.4g}"
        max_err["crossbar_bwd"] = max(max_err["crossbar_bwd"], close(
            dx, xbk.crossbar_bwd_plain(dys, gp, gm, dy_scale=scale),
            f"bwd {what}"))
        max_err["crossbar_dw"] = max(max_err["crossbar_dw"], close(
            dw, xbk.crossbar_dw_plain(xs, dys, dy_scale=scale),
            f"dw {what}"))
        want = xbk.pulse_update_plain(gp, gm, xs, ds, **rule)
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        flips += check_pulse_counts(gp, gm, new, want, counts,
                                    f"pulse {what}")
        max_err["pulse_update"] = max(max_err["pulse_update"], max(
            float((a - b).abs().max()) for a, b in zip(new, want)))
        if M == 4096 and not lead and not case.get("codes"):
            rows += time_train_shape(xbk, xs, ds, gp, gm, rule)
    for K, N in MNIST_LAYERS:   # crossbar_apply's dw shapes, int8 codes
        xs = uniform((1, 4096, K), -0.5, 0.5, gen)
        codes = torch.randint(-127, 128, (1, 4096, N), generator=gen,
                              dtype=torch.int8, device="cuda")
        scale = torch.tensor(0.05 / 127, device="cuda")
        close(xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
              xbk.crossbar_dw_plain(xs, codes, dy_scale=scale),
              f"dw codes (1, 4096, {K}, {N})")
        rows.append(time_dw_codes(xbk, xs, codes, scale))
    print(f"train kernel phase: {len(cases) + len(MNIST_LAYERS)} cases, max "
          f"|kernel - plain| " + json.dumps(max_err) + f" (atol {ATOL} + "
          f"rtol {ATOL}; pulse: conductances), {flips} pulse counts one "
          f"apart at a half-integer (within {PULSE_BOUNDARY})")
    return max_err, rows


def time_row(kernel, T, M, K, N, fns, dy_bytes=4, **extra) -> dict:
    """CUDA-event times of ``fns`` (name -> callable) beside the bound."""
    flop_ms, byte_ms = bound(T, M, K, N, kernel, dy_bytes)
    row = {"kernel": kernel, "T": T, "M": M, "K": K, "N": N, **extra}
    row.update({k: cuda_ms(f) for k, f in fns.items()})
    row.update(bound_ms=max(flop_ms, byte_ms),
               bound_by="operations" if flop_ms >= byte_ms else "bytes")
    return row


def time_train_shape(xbk, xs, ds, gp, gm, rule) -> list[dict]:
    """Kernel / plain / ``torch.bmm`` times of bwd, dw and pulse on one
    stage stack (pulse's bmm is its product alone, without the epilogue)."""
    T, M, K = xs.shape
    N = ds.shape[2]
    xt = xs.transpose(1, 2)
    return [
        time_row("crossbar_bwd", T, M, K, N, {
            "ms": lambda: xbk.crossbar_bwd_kernel(ds, gp, gm),
            "plain_ms": lambda: xbk.crossbar_bwd_plain(ds, gp, gm),
            "library_ms": lambda: torch.bmm(ds, (gp - gm).transpose(1, 2)),
        }),
        time_row("crossbar_dw", T, M, K, N, {
            "ms": lambda: xbk.crossbar_dw_kernel(xs, ds),
            "plain_ms": lambda: xbk.crossbar_dw_plain(xs, ds),
            "library_ms": lambda: torch.bmm(xt, ds),
        }),
        time_row("pulse_update", T, M, K, N, {
            "ms": lambda: xbk.pulse_update_kernel(gp, gm, xs, ds, **rule),
            "plain_ms": lambda: xbk.pulse_update_plain(gp, gm, xs, ds,
                                                       **rule),
            "library_ms": lambda: torch.bmm(xt, ds),
        }, library="bmm without the pulse epilogue"),
    ]


def time_dw_codes(xbk, xs, codes, scale) -> dict:
    T, M, K = xs.shape
    N = codes.shape[2]
    dys = codes.float() * scale
    return time_row("crossbar_dw", T, M, K, N, {
        "ms": lambda: xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
        "plain_ms": lambda: xbk.crossbar_dw_plain(xs, codes,
                                                  dy_scale=scale),
        "library_ms": lambda: torch.bmm(xs.transpose(1, 2), dys),
    }, dy_bytes=1, codes="int8")


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def check_chip_wave(chip, x, out, mlp_forward, spec) -> int:
    """Hold a chip wave against the plain product stage by stage (on the
    chip's own stage inputs) and end to end against plain ``mlp_forward``.
    Returns the number of samples downstream of a boundary code flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    acts, dps, wave_out = chip.forward_wave(x, count=False)
    if not torch.equal(wave_out, out):
        raise AssertionError("forward_wave and infer_stream disagree")
    layers = chip.layers()
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s, p in enumerate(layers):
        dp_ref = acts[s] @ (p["g_plus"] - p["g_minus"])
        err = float((dps[s] - dp_ref).abs().max())
        if not err <= ATOL:
            raise AssertionError(f"stage {s}: dp max |err| {err}")
        if s + 1 < len(layers):
            flipped |= code_flips(hard_sigmoid(dp_ref), acts[s + 1])
    err = float((out - hard_sigmoid(dp_ref)).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"chip output vs last stage: max |err| {err}")
    ref = mlp_forward(layers, x, spec, device="cuda")
    off = ((out - ref).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError("chip output differs from mlp_forward on a "
                             "sample with no boundary code flip")
    return int(flipped.sum())


def check_mlp_kernel(layers, x, spec, ops, mlp_forward) -> int:
    """``mlp_forward(use_kernel=True)`` against its plain version, layer by
    layer on the kernel path's own inputs and end to end."""
    from repro_torch.core.crossbar import hard_sigmoid
    launches0 = ops.crossbar_fwd.launches
    out = mlp_forward(layers, x, spec, use_kernel=True, device="cuda")
    if ops.crossbar_fwd.launches - launches0 != len(layers):
        raise AssertionError("mlp_forward(use_kernel=True) did not launch "
                             "the kernel once per layer")
    h = x
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for li, p in enumerate(layers):
        bits = ADC_BITS if li < len(layers) - 1 else None
        hk = ops.crossbar_fwd(h, p["g_plus"], p["g_minus"], activation=True,
                              adc_bits=bits)
        pre = hard_sigmoid(h @ (p["g_plus"] - p["g_minus"]))
        if bits is None:
            err = float((hk - pre).abs().max())
            if not err <= ATOL:
                raise AssertionError(f"layer {li}: max |err| {err}")
        else:
            flipped |= code_flips(pre, hk)
        h = hk
    if not torch.equal(h, out):
        raise AssertionError("mlp_forward(use_kernel=True) is not "
                             "deterministic")
    ref = mlp_forward(layers, x, spec, device="cuda")
    off = ((out - ref).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError("mlp_forward kernel path differs from plain on "
                             "a sample with no boundary code flip")
    return int(flipped.sum())


def run_wave(chip, x, ops, expected: int):
    before = ops.crossbar_fwd_stacked.launches
    out, stats = chip.infer_stream(x)
    torch.cuda.synchronize()
    got = ops.crossbar_fwd_stacked.launches - before
    if got != expected:
        raise AssertionError(f"{chip.name}: {got} kernel launches in a wave "
                             f"of {x.shape[0]}, expected {expected}")
    if tuple(out.shape) != (x.shape[0], chip.placement.dims[-1]) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{chip.name}: bad output {tuple(out.shape)}")
    return out, stats


def check_report(chip, hw) -> dict:
    cmp_ = chip.report().compare_hw(
        hw.network_cost(chip.name, list(chip.placement.dims)))
    bad = {k: v for k, v in cmp_.items() if not v <= 0.01}
    if bad or set(cmp_) != {"infer_time", "infer_energy", "infer_io"}:
        raise AssertionError(f"{chip.name}: hw_model cross-validation {cmp_}")
    ref = hw.PAPER_TABLE_IV[chip.name]["time_us"]
    if not abs(chip.beat_us - ref) / ref <= 0.01:
        raise AssertionError(f"{chip.name}: beat {chip.beat_us} us")
    return cmp_


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for ``kernels.ops`` inside ``sim.chip`` and records the
    arguments and results of the stacked bwd and pulse wrappers, so every
    stage can be held against the plain versions on its own inputs.  It
    launches nothing itself: the real wrappers count their launches."""

    NAMES = ("crossbar_bwd_stacked", "pulse_update_stacked")

    def __init__(self, ops):
        self._ops = ops
        self.calls = {n: [] for n in self.NAMES}

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name not in self.NAMES:
            return fn

        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name].append((args, kwargs, out))
            return out
        return record


def plain_rule(layers, x, target, spec, lr) -> list[dict]:
    """Per layer, what the plain paper rule computes inside a step: the
    unrounded pulse counts 2 lr (a^T local) / (B u), the local error, and
    |delta| / scale before the 8-bit error rounding."""
    from repro_torch.core import quantization as q
    from repro_torch.core.crossbar import hard_sigmoid, hard_sigmoid_deriv
    acts, dps, h = [], [], x
    for li, p in enumerate(layers):
        if li > 0 and spec.transport_quant:
            h = q.adc_quantize(h, spec.adc_bits)
        acts.append(h)
        dps.append(h @ (p["g_plus"] - p["g_minus"]))
        h = hard_sigmoid(dps[-1])
    delta = target - h
    unit = spec.max_update / spec.update_levels
    out = [None] * len(layers)
    for li in reversed(range(len(layers))):
        qt = q.error_quantize(delta, spec.err_bits)
        ratio = delta.abs() / qt.scale
        if spec.error_quant:
            delta = qt.dequantize()
        local = delta * hard_sigmoid_deriv(dps[li])
        acc = (acts[li].T @ local).double()
        out[li] = {"counts": 2.0 * lr * acc / x.shape[0] / unit,
                   "local": local, "ratio": ratio}
        w = layers[li]["g_plus"] - layers[li]["g_minus"]
        delta = local @ w.T
    return out


def untile(stack: torch.Tensor, st) -> torch.Tensor:
    """(r*c, rows, cols) core stack -> the (fan_in, fan_out) layer."""
    r, c = st.row_tiles, st.col_tiles
    full = (stack.reshape(r, c, st.rows, st.cols).permute(0, 2, 1, 3)
            .reshape(r * st.rows, c * st.cols))
    return full[1:st.lmap.fan_in + 1, :st.lmap.fan_out]


def chip_stage_inputs(chip, bwd, pulse) -> list[dict]:
    """Per layer, the chip's own stage inputs read back from its bwd and
    pulse launches: input activations (core i*c holds fan-in tile i), local
    errors (core j holds fan-out tile j) and the unrounded pulse counts of
    the plain rule on them."""
    from repro_torch.kernels import crossbar as xbk
    out = [None] * len(chip.placement.stages)
    for (bargs, _, _), (pargs, pkw, _), st in zip(
            bwd, pulse, reversed(chip.placement.stages)):
        xs, ds = pargs[2], pargs[3]
        r, c = st.row_tiles, st.col_tiles
        counts = xbk.pulse_counts_plain(xs, ds, lr=pkw["lr"],
                                        max_dw=pkw["max_dw"],
                                        levels=pkw["levels"])
        out[st.index] = {
            "act": torch.cat([xs[i * c] for i in range(r)],
                             dim=1)[:, 1:st.lmap.fan_in + 1],
            "local": torch.cat([bargs[0][j] for j in range(c)],
                               dim=1)[:, :st.lmap.fan_out],
            "counts": untile(counts, st).double(),
        }
    return out


def clone_layers(chip) -> list[dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in p.items()} for p in chip.layers()]


def check_train_step(chip, rec, n, layers0, layers1, x, target, err, spec,
                     paper_backprop_step, lr) -> dict:
    """Hold one chip step stage by stage (plain versions on the chip's own
    stage inputs) and whole (the port's plain ``paper_backprop_step`` on
    the same layers and data).  Returns counts of boundary flips.

    Where the chip's own inputs legitimately differ from the plain step's
    — a 3-bit activation code within BOUNDARY of a half-step, or an 8-bit
    error code whose plain |delta|/scale lies within 1e-3 of a half-integer
    (the codes' own rounding boundary; a last-bit difference upstream moves
    it by ~1e-5) — a pulse count may also differ by one where the plain
    counts on the two sides' inputs round apart."""
    from repro_torch.core.crossbar import hard_sigmoid
    from repro_torch.kernels import crossbar as xbk
    S = len(chip.placement.stages)
    bwd = rec.calls["crossbar_bwd_stacked"][n:n + S]
    pulse = rec.calls["pulse_update_stacked"][n:n + S]
    stage_flips = 0
    for (bargs, bkw, dx), (pargs, pkw, new) in zip(bwd, pulse):
        close(dx, xbk.crossbar_bwd_plain(*bargs, **bkw),
              f"{chip.name} stage dx")
        want = xbk.pulse_update_plain(*pargs, **pkw)
        counts = xbk.pulse_counts_plain(pargs[2], pargs[3], lr=pkw["lr"],
                                        max_dw=pkw["max_dw"],
                                        levels=pkw["levels"])
        stage_flips += check_conductances(new, want, counts,
                                          f"{chip.name} stage g±")
    ours = chip_stage_inputs(chip, bwd, pulse)
    plain = plain_rule(layers0, x, target, spec, lr)
    # forward codes on the chip's own stage inputs
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(1, S):
        p = layers0[s - 1]
        pre = hard_sigmoid(ours[s - 1]["act"] @ (p["g_plus"] - p["g_minus"]))
        flipped |= code_flips(pre, ours[s]["act"])
    # error codes: the first layer (from the output) whose local error
    # differs must differ at a code boundary; what lies below follows it
    err_flips = 0
    for s in reversed(range(S)):
        off = (ours[s]["local"] - plain[s]["local"]).abs() > ATOL
        off &= ~flipped[:, None]
        if bool(off.any()):
            r = plain[s]["ratio"][off]
            if bool(((r - torch.floor(r) - 0.5).abs() > 1e-3).any()):
                raise AssertionError(f"{chip.name}: layer {s} local error "
                                     f"differs off an 8-bit code boundary")
            err_flips = int(off.sum())
            break
    # the whole step against the plain rule on the same layers and data
    want_layers, want_err = paper_backprop_step(layers0, x, target, spec,
                                                lr)
    off = ((err - want_err).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip.name}: step error differs from "
                             f"paper_backprop_step off a code flip")
    inputs_differ = bool(flipped.any()) or err_flips > 0
    step_flips = 0
    for li, (got, want) in enumerate(zip(layers1, want_layers)):
        counts = plain[li]["counts"]
        if inputs_differ:   # excuse cells the two sides' inputs round apart
            apart = torch.round(ours[li]["counts"]) != torch.round(counts)
            counts = torch.where(apart, torch.full_like(counts, 0.5),
                                 counts)
        step_flips += check_conductances(
            (got["g_plus"], got["g_minus"]),
            (want["g_plus"], want["g_minus"]), counts,
            f"{chip.name} step layer {li} vs paper_backprop_step")
    return {"stage_pulse_flips": stage_flips, "step_pulse_flips": step_flips,
            "fwd_code_flip_samples": int(flipped.sum()),
            "err_code_flips": err_flips}


def train_path(ops, chip_mod, build_chip, spec, paper_backprop_step, hw,
               gen) -> dict:
    """The training main path (see the module docstring, step 5)."""
    mnist = build_chip("mnist_class", seed=SEED, device="cuda")
    isolet = build_chip("isolet_class", seed=SEED, device="cuda")
    # one counted recognition wave each, so compare_hw has its infer keys
    mnist.infer(uniform((4, 784), -0.5, 0.5, gen))
    isolet.infer(uniform((4, 617), -0.5, 0.5, gen))
    steps = ([(mnist, 1)] * 3 + [(mnist, 4096)] * 2 + [(isolet, 256)])
    data = [(chip, uniform((B, chip.placement.dims[0]), -0.5, 0.5, gen),
             uniform((B, chip.placement.dims[-1]), -0.5, 0.5, gen))
            for chip, B in steps]
    initial = {c.name: clone_layers(c) for c in (mnist, isolet)}
    rec = Recorder(ops)
    names = ("crossbar_fwd_stacked", "crossbar_bwd_stacked",
             "pulse_update_stacked")
    chip_mod.kernel_ops = rec
    try:
        for n in names:
            getattr(ops, n).launches = 0
        snaps, errs = [None], []
        for chip, x, t in data:
            errs.append(chip.train_step(x, t, lr=LR))
            snaps.append(clone_layers(chip))
        torch.cuda.synchronize()
        launches = {n: getattr(ops, n).launches for n in names}
    finally:
        chip_mod.kernel_ops = ops
    expect = 4 * 5 + 5 * 1
    if launches["crossbar_bwd_stacked"] != expect or \
            launches["pulse_update_stacked"] != expect:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expect} bwd and {expect} pulse")
    print(f"training path: launches {json.dumps(launches)} (bwd + pulse: "
          f"4 + 4 per mnist step x 5, 5 + 5 per isolet step x 1)")
    flips, n = [], 0
    for i, ((chip, x, t), err) in enumerate(zip(data, errs)):
        if tuple(err.shape) != tuple(t.shape) or \
                not bool(torch.isfinite(err).all()):
            raise AssertionError(f"{chip.name}: bad step error")
        before = snaps[i] if i and data[i - 1][0] is chip \
            else initial[chip.name]
        flips.append(check_train_step(chip, rec, n, before, snaps[i + 1], x,
                                      t, err, spec, paper_backprop_step, LR))
        n += len(chip.placement.stages)
    print("training steps held against plain (batch 1 x3, 4096 x2 mnist; "
          "256 isolet): " + json.dumps(flips))
    keys = {"infer_time", "infer_energy", "infer_io", "train_time",
            "train_energy", "train_io"}
    for chip in (mnist, isolet):
        cmp_ = chip.report().compare_hw(
            hw.network_cost(chip.name, list(chip.placement.dims)))
        if set(cmp_) != keys or not all(v <= 0.01 for v in cmp_.values()):
            raise AssertionError(f"{chip.name}: hw_model cross-validation "
                                 f"{cmp_}")
        print(f"{chip.name} after training: hw_model rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    return launches


def apply_grads(layers, x, target, spec, use_kernel: bool):
    """Gradients of a squared-error loss through ``crossbar_apply``; returns
    (leaf params, per-layer inputs, per-layer dot products with .grad)."""
    from repro_torch.core.crossbar import crossbar_apply, hard_sigmoid
    params = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in layers]
    ins, dps, h = [], [], x
    for li, p in enumerate(params):
        ins.append(h.detach())
        dp = crossbar_apply(p, h, spec, activation=False,
                            use_kernel=use_kernel, transport_in=li > 0)
        dp.retain_grad()
        dps.append(dp)
        h = hard_sigmoid(dp)
    ((h - target) ** 2).sum().backward()
    return params, ins, dps


def layer_vjp(p, a, g, spec, li, use_kernel):
    from repro_torch.core.crossbar import crossbar_apply
    leaves = [a.clone().requires_grad_(),
              p["g_plus"].detach().clone().requires_grad_(),
              p["g_minus"].detach().clone().requires_grad_()]
    y = crossbar_apply({"g_plus": leaves[1], "g_minus": leaves[2]},
                       leaves[0], spec, activation=False,
                       use_kernel=use_kernel, transport_in=li > 0)
    return torch.autograd.grad(y, leaves, g)


def apply_path(ops, layers, spec, gen) -> tuple[dict, float]:
    """crossbar_apply(use_kernel=True) gradients (module docstring, step
    6); returns (launch counts, max |kernel - plain|)."""
    names = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw")
    runs = []
    for n in names:
        getattr(ops, n).launches = 0
    for M in (64, 4096):
        x = uniform((M, 784), -0.5, 0.5, gen)
        t = uniform((M, 10), -0.5, 0.5, gen)
        runs.append(apply_grads(layers, x, t, spec, use_kernel=True))
    torch.cuda.synchronize()
    launches = {n: getattr(ops, n).launches for n in names}
    if launches != {n: 8 for n in names}:
        raise AssertionError(f"crossbar_apply(use_kernel=True) launches "
                             f"{launches}, expected 4 per run of 4 layers")
    max_err = 0.0
    for params, ins, dps in runs:
        for li, (p, a, dp) in enumerate(zip(params, ins, dps)):
            got = layer_vjp(p, a, dp.grad, spec, li, use_kernel=True)
            want = layer_vjp(p, a, dp.grad, spec, li, use_kernel=False)
            if not (torch.equal(got[1], p["g_plus"].grad)
                    and torch.equal(got[2], p["g_minus"].grad)):
                raise AssertionError("crossbar_matmul's gradients are not "
                                     "deterministic")
            for name, g, w in zip(("x", "g_plus", "g_minus"), got, want):
                max_err = max(max_err, close(
                    g, w, f"crossbar_apply layer {li} d/d{name} "
                          f"M={a.shape[0]}"))
    print(f"crossbar_apply(use_kernel=True) path: launches "
          f"{json.dumps(launches)} (M = 64 and 4096, 4 layers each), "
          f"gradients vs plain _xbar_matmul layer by layer: max |err| "
          f"{max_err:.3e}")
    return launches, max_err


def profile_device(fn, reps: int = 3) -> dict:
    """Device time per kernel over ``reps`` calls of ``fn``
    (``torch.profiler``), and the device's busy share of their span (CUDA
    events inside the profiled window, so profiler start-up is not
    counted; host-side profiling overhead is)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end) / reps
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {"span_ms": span_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / span_ms,
            "top": [{"kernel": k[:70], "ms": ms, "per_call": n}
                    for k, ms, n in kernels[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core import hw_model as hw
    from repro_torch.core.crossbar import mlp_forward, paper_backprop_step
    from repro_torch.kernels import _build, crossbar as xbk, ops
    from repro_torch.launch.chipsim import build_chip
    from repro_torch.sim import chip as chip_mod

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.load_all(list(KERNELS))
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s "
          f"wall (one nvcc each, in parallel)")
    for lib in libs:
        print(f"  {lib.path.name}: nvcc {lib.build_s:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    phase_s = {"build": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    max_err, rows = kernel_phase(xbk, ops, gen)
    train_err, train_rows = train_kernel_phase(xbk, ops, gen)
    phase_s["kernel phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- recognition path: the counts start at 0 and are read after
    mnist = build_chip("mnist_class", seed=SEED, device="cuda")
    isolet = build_chip("isolet_class", seed=SEED, device="cuda")
    x16 = uniform((16, 784), -0.5, 0.5, gen)
    x4096 = uniform((4096, 784), -0.5, 0.5, gen)
    x_iso = uniform((256, 617), -0.5, 0.5, gen)
    ops.crossbar_fwd_stacked.launches = 0
    ops.crossbar_fwd.launches = 0
    out16, _ = run_wave(mnist, x16, ops, 5)
    out4096, stream = run_wave(mnist, x4096, ops, 5)
    out_iso, stream_iso = run_wave(isolet, x_iso, ops, 9)
    launches = ops.crossbar_fwd_stacked.launches + ops.crossbar_fwd.launches
    print(f"recognition path: {launches} kernel launches (mnist 5 + 5, "
          f"isolet 9)")

    # -- correctness of what came out
    flips = {
        "mnist x16": check_chip_wave(mnist, x16, out16, mlp_forward,
                                     PAPER_SPEC),
        "mnist x4096": check_chip_wave(mnist, x4096, out4096, mlp_forward,
                                       PAPER_SPEC),
        "isolet x256": check_chip_wave(isolet, x_iso, out_iso, mlp_forward,
                                       PAPER_SPEC),
        "mlp_forward(use_kernel) x16": check_mlp_kernel(
            mnist.layers(), x16, PAPER_SPEC, ops, mlp_forward),
        "mlp_forward(use_kernel) x4096": check_mlp_kernel(
            mnist.layers(), x4096, PAPER_SPEC, ops, mlp_forward),
    }
    print("held against plain (samples after a boundary code flip): "
          + json.dumps(flips))
    for chip in (mnist, isolet):
        cmp_ = check_report(chip, hw)
        print(f"{chip.name}: beat {chip.beat_us:.4f} us, hw_model rel err "
              + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))

    phase_s["recognition path"] = time.perf_counter() - t0

    # -- training path and crossbar_apply(use_kernel=True) path
    t0 = time.perf_counter()
    train_launches = train_path(ops, chip_mod, build_chip, PAPER_SPEC,
                                paper_backprop_step, hw, gen)
    phase_s["training path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_launches, apply_err = apply_path(ops, mnist.layers(), PAPER_SPEC,
                                           gen)
    phase_s["crossbar_apply path"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- wave and step times (device events, after warm-up)
    mnist_ms = cuda_ms(lambda: mnist.infer(x4096, count=False), iters=10)
    iso_ms = cuda_ms(lambda: isolet.infer(x_iso, count=False), iters=10)
    t0 = time.perf_counter()
    mnist.infer_stream(x16)
    torch.cuda.synchronize()
    host16_ms = (time.perf_counter() - t0) * 1e3
    print(f"waves: mnist_class 4096 samples {mnist_ms:.3f} ms "
          f"({4096 / mnist_ms * 1e3:.0f} samples/s), isolet_class 256 "
          f"samples {iso_ms:.3f} ms, mnist 16-sample infer_stream "
          f"{host16_ms:.3f} ms host wall [{card}]")
    stepper = build_chip("mnist_class", seed=SEED, device="cuda")
    t4096 = uniform((4096, 10), -0.5, 0.5, gen)
    step_ms = cuda_ms(lambda: stepper.train_step(x4096, t4096, lr=LR),
                      iters=5, warmup=2)
    iso_stepper = build_chip("isolet_class", seed=SEED, device="cuda")
    t_iso = uniform((256, 26), -0.5, 0.5, gen)
    iso_step_ms = cuda_ms(
        lambda: iso_stepper.train_step(x_iso, t_iso, lr=LR), iters=5,
        warmup=2)
    print(f"training: one mnist_class train_step at batch 4096 "
          f"{step_ms:.3f} ms ({4096 / step_ms * 1e3:.0f} samples/s), one "
          f"isolet_class train_step at batch 256 {iso_step_ms:.3f} ms "
          f"[{card}]")
    print("kernel shapes (M=4096): " + json.dumps(rows + train_rows))
    print("profile, mnist_class 4096-sample wave (profiler on): "
          + json.dumps(profile_device(
              lambda: mnist.infer(x4096, count=False))))
    print("profile, mnist_class train_step at batch 4096 (profiler on): "
          + json.dumps(profile_device(
              lambda: stepper.train_step(x4096, t4096, lr=LR))))

    fwd_rows = {(r["T"], r["K"], r["N"]): r for r in rows
                if r["app"] == "mnist_class"}
    by_kernel = {
        "crossbar_fwd": ([fwd_rows[s] for s in WAVE_SHAPES["mnist_class"]],
                         "the 5 launches of one mnist_class wave at M=4096"),
        "crossbar_bwd": (step_rows(train_rows, "crossbar_bwd"),
                         "the 4 launches of one mnist_class training step "
                         "at M=4096"),
        "pulse_update": (step_rows(train_rows, "pulse_update"),
                         "the 4 launches of one mnist_class training step "
                         "at M=4096"),
        "crossbar_dw": ([r for r in train_rows if r.get("codes")],
                        "the 4 launches of crossbar_apply(use_kernel=True)'s "
                        "backward through mnist's layers at M=4096, int8 "
                        "codes"),
    }
    counted = {
        "crossbar_fwd": launches + train_launches["crossbar_fwd_stacked"]
        + apply_launches["crossbar_fwd"],
        "crossbar_bwd": train_launches["crossbar_bwd_stacked"]
        + apply_launches["crossbar_bwd"],
        "crossbar_dw": apply_launches["crossbar_dw"],
        "pulse_update": train_launches["pulse_update_stacked"],
    }
    errs = {"crossbar_fwd": max_err, **train_err}
    errs["crossbar_bwd"] = max(errs["crossbar_bwd"], apply_err)
    errs["crossbar_dw"] = max(errs["crossbar_dw"], apply_err)
    replaces = {"crossbar_fwd": 84, "crossbar_bwd": 145, "crossbar_dw": 207,
                "pulse_update": 403}
    entries = []
    for name in KERNELS:
        timed, what = by_kernel[name]
        flop_ms = sum(bound(r["T"], r["M"], r["K"], r["N"], name,
                            1 if r.get("codes") else 4)[0] for r in timed)
        byte_ms = sum(bound(r["T"], r["M"], r["K"], r["N"], name,
                            1 if r.get("codes") else 4)[1] for r in timed)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/crossbar.py:{replaces[name]}",
            "launches": counted[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in timed),
            "timed": what,
        })
    phase_s["timing and profiles"] = time.perf_counter() - t0
    print("phase seconds: " + json.dumps(
        {k: round(v, 2) for k, v in phase_s.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def step_rows(rows: list[dict], kernel: str) -> list[dict]:
    """The timing rows of one mnist_class training step's launches."""
    by_shape = {(r["T"], r["K"], r["N"]): r for r in rows
                if r["kernel"] == kernel and not r.get("codes")}
    return [by_shape[s] for s in TRAIN_SHAPES["mnist_class"]]


if __name__ == "__main__":
    sys.exit(main())
