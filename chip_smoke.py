#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them, and
when run from a directory that does not hold the repository's ``src/``.
Imports nothing of JAX or of the JAX package.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for every fp32 matmul and convolution;
2. builds the crossbar forward kernel from ``src/repro_torch/kernels/csrc``
   and prints the build time and ptxas' register/spill report;
3. kernel phase: holds the CUDA kernel against its plain PyTorch version on
   the card at every mnist_class and isolet_class stage shape (M = 16 and
   M = 4096), a ragged shape, a chip-axis (4-D) case and the fused
   activation + 3-bit ADC epilogue; times the kernel, the plain version and
   ``torch.bmm(xs, gp - gm)`` at the M = 4096 shapes beside the bound;
4. main path: ``build_chip("mnist_class")`` at full width (784-300-200-100-10,
   13 cores) runs ``infer_stream`` on 16 samples and on a 4096-sample wave,
   then ``build_chip("isolet_class")`` (160 cores) one 256-sample wave, with
   the kernel's launch count set to 0 before and read after: every stage
   must go through the kernel (5 launches per mnist wave, 9 per isolet
   wave).  Outputs are held against the port's plain ``mlp_forward`` and,
   stage by stage, against the plain product on the chip's own stage inputs;
   ``mlp_forward(use_kernel=True)`` is held against its plain version; the
   measured counters must agree with ``hw_model`` within 1 % and the beat
   must be Table IV's 0.77 us within 1 %;
5. prints the wave times (CUDA events) and a ``torch.profiler`` breakdown
   of one mnist wave's device time, one ``{"kernels": [...]}`` line, and
   last ``{"ok": true, "device": {...}}``.

Tolerances: fp32 values agree within 1e-5 absolute (the repo's kernel
bar; the two sides sum in different orders).  Quantized activations are
compared as 3-bit codes; a code may differ only where the value before the
ADC lies within 1e-6 of a half-step boundary, where a last-bit difference in
the sum legitimately rounds the other way — and then only the samples
downstream of such a flip may differ end to end.  Any failure raises.
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
ADC_BITS, ADC_RANGE = 3, 0.5
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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def uniform(shape, lo, hi, gen) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * (hi - lo) + lo).cuda()


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


def bound(T, M, K, N) -> tuple[float, float]:
    """(ms at the fp32 rate, ms at the HBM rate) for one launch: each input
    byte read once and each output byte written once."""
    flops = 2.0 * T * M * K * N + T * K * N        # products + delta
    nbytes = 4.0 * T * (M * K + 2 * K * N + M * N)
    return flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3


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
    flop_ms, byte_ms = bound(T, M, K, N)
    return {
        "app": app, "T": T, "M": M, "K": K, "N": N,
        "ms": cuda_ms(lambda: xbk.crossbar_fwd_kernel(
            xs, gp, gm, activation=False)),
        "plain_ms": cuda_ms(lambda: xbk.crossbar_fwd_plain(
            xs, gp, gm, activation=False)),
        "library_ms": cuda_ms(lambda: torch.bmm(xs, gp - gm)),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
    }


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


def profile_wave(chip, x, waves: int = 3) -> dict:
    """Device time per kernel over ``waves`` recognition waves
    (``torch.profiler``), and the device's busy share of the waves' span
    (CUDA events inside the profiled window, so profiler start-up is not
    counted; host-side profiling overhead is)."""
    from torch.profiler import ProfilerActivity, profile
    chip.infer(x, count=False)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(waves):
            chip.infer(x, count=False)
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end) / waves
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / waves, e.count // waves)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return {"wave_span_ms": span_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / span_ms,
            "top": [{"kernel": k[:70], "ms": ms, "per_wave": n}
                    for k, ms, n in kernels[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core import hw_model as hw
    from repro_torch.core.crossbar import mlp_forward
    from repro_torch.kernels import _build, crossbar as xbk, ops
    from repro_torch.launch.chipsim import build_chip

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    lib = _build.load("crossbar_fwd")
    print(f"build: {lib.path.name} in {lib.build_s:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    max_err, rows = kernel_phase(xbk, ops, gen)

    # -- main path: the counts start at 0 and are read after the waves
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
    print(f"main path: {launches} kernel launches (mnist 5 + 5, isolet 9)")

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

    # -- wave times (device events, after warm-up, counters untouched)
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
    print("kernel shapes (M=4096): " + json.dumps(rows))
    print("profile, mnist_class 4096-sample wave (profiler on): "
          + json.dumps(profile_wave(mnist, x4096)))

    mnist_rows = [r for r in rows if r["app"] == "mnist_class"]
    by_shape = {(r["T"], r["K"], r["N"]): r for r in mnist_rows}
    wave = [by_shape[s] for s in WAVE_SHAPES["mnist_class"]]
    flop_ms = sum(bound(r["T"], r["M"], r["K"], r["N"])[0] for r in wave)
    byte_ms = sum(bound(r["T"], r["M"], r["K"], r["N"])[1] for r in wave)
    entry = {
        "name": "crossbar_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/crossbar_fwd.cu",
        "replaces": "src/repro/kernels/crossbar.py:84",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in wave),
        "plain_ms": sum(r["plain_ms"] for r in wave),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": sum(r["library_ms"] for r in wave),
        "timed": "the 5 launches of one mnist_class wave at M=4096",
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
