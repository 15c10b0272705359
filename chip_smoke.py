#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without them, and
when run from a directory that does not hold the repository's ``src/``.
Imports nothing of JAX or of the JAX package.  In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for every fp32 matmul and convolution;
2. builds the eight kernel sources from ``src/repro_torch/kernels/csrc``
   (five crossbar kernels, the k-means assignment, flash attention on the
   tensor cores for bf16 and on the CUDA cores for fp32; one nvcc per
   source, all started together; dw and pulse share the header
   ``outer_product.cuh``) and prints the build time and ptxas'
   register/spill report, and per dw and pulse instance its registers,
   spills and shared memory (a spill fails the run);
3. kernel phases: hold each CUDA kernel against its plain PyTorch version
   on the card — the forward at every mnist_class and isolet_class
   recognition stage shape (M = 16 and 4096), a ragged shape, a chip-axis
   (4-D) case and the fused activation + 3-bit ADC epilogue; the error
   backprop, weight gradient and pulse update at every training stage
   stack (M = 1, 64 and 4096), a ragged shape (K = 300, N = 26), a
   chip-axis case and the int8 error-code path of bwd and dw; the fused
   training kernel at every training stage stack (M = 1, 64, 4096), the
   ragged zero-padded stacks and int8 codes of the reference's megakernel
   sweep and a chip-axis case, with the forward on, and off with the update
   copied in place — held against its plain version and BIT FOR BIT
   against the four-call sequence (fwd without activation, bwd, pulse on
   the dequantized error) — and time each kernel, its plain version and
   ``torch.bmm`` for the same contraction at M = 4096 beside the bound
   (dw and pulse rows also by device time, a CUDA graph of 20 calls
   replayed, for the kernel and for ``torch.bmm``); the dw and pulse
   kernels' bit pins, which tie them and the fused kernel to one summation
   order: (a) dw on int8 codes with a scale equals dw on ``codes.float() *
   scale``, (b) pulse_update equals the plain pulse epilogue applied to the
   dw kernel's product, both bit for bit at every training stage stack (M =
   1, 64, 4096), mnist's four layers and the ragged shapes, and every tile
   of ``OUTER_PRODUCT_TILES`` equal to the picked one (fp32, int8 and
   int32 codes, pulse) on ragged shapes and operands whose addresses are
   not 16-byte aligned; a sweep of every tile's device time at the main
   paths' dw and pulse launches beside the tile the wrapper picks; the
   ptxas registers, spills (none allowed) and shared memory of every dw and
   pulse instance; and the k-means assignment kernel at the clustering
   path's shape (n = 2048, d = 20, k = 10), n = 60000, k = 26, the
   hardware core's 32 x 32,
   the TPU tile limit 128 x 128 (n = 65536), a ragged n, k = 1 and
   duplicated centers (exact ties go to the lowest index), timed beside its
   plain version, ``torch.cdist(p=1).argmin`` and the bound; and the flash
   attention kernels at qwen2-0.5b's prefill shape (B=4, S=2048, 14 heads
   on 2, hd 64) in bf16 and fp32, the yi-6b head shape (1, 4096, 32 on 4,
   hd 128), a ragged S = 1000, non-causal 384, MHA, the reference test's
   four shapes, each in both of the reference's functions
   (``semantics="chunked"``, the LM prefill's, and ``"pallas"``) against
   the matching plain version, the bf16 chunked function also against the
   plain version at the kernel's own 64-key tiles, and each bf16
   function's mean distance to its own plain version at most a quarter of
   its distance to the other function's; and strided views (through
   ``ops.flash_attention``, the model's wrapper: fp32 read through their
   strides, bf16 aligned views uncopied, a misaligned one copied and
   counted), timed beside the plain version,
   ``scaled_dot_product_attention`` (never called by the port) and the
   bound (both products, four for the Pallas function in bf16, at the
   bf16 tensor-core rate for bf16 operands, at the fp32 rate for fp32;
   the exponentials' co-bound printed beside), with each instance's
   registers, spills and shared memory;
4. eager recognition path (``compiled=False``): ``build_chip`` for
   mnist_class at full width (784-300-200-100-10, 13 cores) runs
   ``infer_stream`` on 16 samples and on a 4096-sample wave, isolet_class
   (160 cores) one 256-sample wave, with the forward kernel's launch count
   set to 0 before and read after (5 launches per mnist wave, 9 per isolet
   wave).  Outputs are held against the port's plain ``mlp_forward`` and,
   stage by stage, against the plain product on the chip's own stage
   inputs; ``mlp_forward(use_kernel=True)`` against its plain version; the
   counters against ``hw_model`` within 1 % and the beat against Table
   IV's 0.77 us;
5. compiled recognition path (the chip's default): the same three waves,
   each twice (the first call captures the CUDA graph, the second
   replays it), counts at 0 before and read after: 4 forward launches per
   mnist wave, 5 per isolet wave, one capture per (program, shape); each
   replay equals its first run, is held like step 4 and against the eager
   chip's output on the same conductances;
6. eager training path (``compiled=False``): with every count set to 0,
   mnist_class takes 3 ``train_step``s at batch 1 and 2 at batch 4096, and
   isolet_class one at batch 256.  Each stage's backward phase must be one
   bwd launch and its update one pulse launch (4 + 4 per mnist step, 5 + 5
   per isolet step); every stage's dx and new conductances are held
   against the plain versions on the chip's own stage inputs, each whole
   step against the port's plain ``paper_backprop_step`` on the same
   layers and data, and ``compare_hw`` within 1 % on all six keys;
7. compiled training path: the same six steps on compiled chips, the lr
   halved before the third batch-1 step (no new capture), counts at 0
   before and read after: 4 forward + 4 fused launches per mnist step, 5 +
   5 per isolet step, one capture per batch; the envelope's address does
   not move.  Every stage is held against the plain versions on its own
   inputs (read back from the graph's memory after each replay), and each
   step against the eager chip's step from the same conductances;
8. ``crossbar_apply(use_kernel=True)`` path: the gradients of a
   squared-error loss through mnist's four layers at M = 64 and 4096, with
   8-bit error quantization, through ``crossbar_matmul`` (one bwd and one
   dw launch per layer), held layer by layer against the plain
   ``_xbar_matmul`` path on the same inputs;
9. paper-apps path at full width, the k-means launch count set to 0
   before and read after: ``mnist_like(2048)`` through ``pretrain_stack``
   on Table I's mnist_dimred (784-300-200-100-20, PAPER_SPEC, 2 epochs;
   depth not cut), ``encode`` to 20-d features, ``init_plusplus(k=10)`` and
   ``kmeans_fit(epochs=15, use_kernel=True)`` (one launch), one more
   ``assign(use_kernel=True)`` (one launch, equal to the first); the
   kernel's assignment held against the plain ``assign``, inertia never
   rising; then ``kdd_like(4096, 1024)`` through ``pretrain_layer`` on
   kdd_anomaly (41-15-41, 3 epochs) and ``reconstruction_error`` on normal
   and attack traffic, printing detection at 4 % FPR and AUC beside the
   paper's 96.6 %, and each stage's time (CUDA events);
10. LM prefill path, the flash counts set to 0 before and read after:
    ``build_model`` for the full qwen2-0.5b config on ``cuda``, parameters
    from ``init`` with seed 0, ``prefill_fn`` on 4 x 2048 tokens drawn from
    seed 0: exactly 24 flash launches (one per layer), all on the
    tensor-core kernel in ``chunked_attention``'s function, logits (4, 2048,
    152064) finite with the 128 pad columns at -1e30; its time (CUDA
    events), tokens/s and a profile; then the same in float32 compute
    (``compute_dtype="float32"``, the same parameters), its counts set to
    0 before and read after: 24 launches, all on the CUDA-core kernel in
    the chunked function, and its time;
11. LM decode against prefill at full width: ``BatchedServer(batch=4,
    max_len=256)`` serves ``launch/serve.py``'s 8-token prompts with
    ``max_new=32`` (39 steps, 128 tokens), its decode logits recorded and
    its flash launches counted (0: the server only decodes, and decode
    attention is plain); ``prefill_fn`` on each slot's prompt + generated
    tokens (a check: its 24 launches are not the path's) must give the same logits at every step within 0.125 in bf16
    and 1e-3 in float32 compute with a float32 cache (its prefill on the
    fp32 kernel, also in the chunked function), and every generated
    token must be the prefill argmax except where its top-2 gap lies within
    that bar (counted); decode ms per step, tokens/s and a profiled step;
12. prints the wave and training-step times (CUDA events), compiled beside
    eager, ``torch.profiler`` breakdowns of the waves and steps with the
    device's idle share, the kernels of one profiled replay (the port's
    kernels and only those), one ``{"kernels": [...]}`` line with eight
    entries (the fp32 flash kernel as ``flash_attention_simt``), and last
    ``{"ok": true, "device": {...}}``.

Tolerances: fp32 values agree within 1e-5 absolute plus 1e-5 relative (the
repo's kernel bar; the two sides sum in different orders).  Quantized
activations are compared as 3-bit codes; a code may differ only where the
value before the ADC lies within 1e-6 of a half-step boundary — and then
only the samples downstream of such a flip may differ end to end.  Pulse
counts may differ by one only where the plain unrounded count lies within
1e-4 of a half-integer; there a conductance may differ by one half pulse
(u/2 = 1.95e-4), everywhere else by at most 1e-6.  The fused kernel and
the four-call sequence must agree exactly.  k-means assignments are
equal, except where the two smallest distances of a sample (recomputed in
float64) lie within 1e-5 relative of each other.  Flash attention in
fp32 within 2e-5 absolute plus relative (the reference's kernel bar); in
bf16, the Pallas function within one bf16 step of the plain result (the
spacing of bf16 at the larger magnitude, plus 1e-6: both sides round an
fp32 value once), the chunked function within one bf16 step plus 2^-8 of
the plain side's sum_j p_j |v_j| / l against the plain version at the
reference's 512-key chunks (``check_flash``), and within one bf16 step
plus 2^-7 max_j p_j |v_j| / l against the plain version at the kernel's
64-key tiles (``check_chunked_tile`` derives both).  Any failure raises.
"""
from __future__ import annotations

import json
import math
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
BF16_FLOPS = 989e12      # H100 SXM bf16 tensor-core peak (dense)
EXP_RATE = 3.9e12        # H100 SXM special-function (exp) rate, per second
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
KERNELS = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
           "crossbar_train", "kmeans_assign", "flash_attention",
           "flash_attention_tc")
# (chip, batch, lr) of the training main path, in order
STEPS = ([("mnist_class", 1, LR)] * 2 + [("mnist_class", 1, LR / 2)]
         + [("mnist_class", 4096, LR)] * 2 + [("isolet_class", 256, LR)])


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: one CUDA graph of ``calls`` calls,
    replayed ``reps`` times between two events after a warm-up, so the
    host's cost of a call (checks, allocation, launch) is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


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
    elif kernel == "crossbar_train":   # dx + dw products, delta, epilogue
        flops = 4.0 * T * M * K * N + 11.0 * T * K * N
        nbytes = T * (2 * M * K * 4 + M * N * dy_bytes + 4 * K * N * 4)
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
    max_err = {k: 0.0 for k in ("crossbar_bwd", "crossbar_dw",
                                "pulse_update")}
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
        with_device_ms(time_row("crossbar_dw", T, M, K, N, {
            "ms": lambda: xbk.crossbar_dw_kernel(xs, ds),
            "plain_ms": lambda: xbk.crossbar_dw_plain(xs, ds),
            "library_ms": lambda: torch.bmm(xt, ds),
        }), lambda: xbk.crossbar_dw_kernel(xs, ds),
            lambda: torch.bmm(xt, ds), xbk.outer_product_tile(T, M, K, N, 4)),
        with_device_ms(time_row("pulse_update", T, M, K, N, {
            "ms": lambda: xbk.pulse_update_kernel(gp, gm, xs, ds, **rule),
            "plain_ms": lambda: xbk.pulse_update_plain(gp, gm, xs, ds,
                                                       **rule),
            "library_ms": lambda: torch.bmm(xt, ds),
        }, library="bmm without the pulse epilogue"),
            lambda: xbk.pulse_update_kernel(gp, gm, xs, ds, **rule),
            lambda: torch.bmm(xt, ds), xbk.outer_product_tile(T, M, K, N, 4)),
    ]


def with_device_ms(row: dict, kernel, library, tile: int) -> dict:
    """Add the kernel's and the library call's device times (``graph_ms``)
    and the tile the wrapper picked to a row."""
    row.update(ms_device=graph_ms(kernel), library_ms_device=graph_ms(library),
               tile=tile)
    return row


def time_dw_codes(xbk, xs, codes, scale) -> dict:
    T, M, K = xs.shape
    N = codes.shape[2]
    dys = codes.float() * scale
    return with_device_ms(time_row("crossbar_dw", T, M, K, N, {
        "ms": lambda: xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
        "plain_ms": lambda: xbk.crossbar_dw_plain(xs, codes,
                                                  dy_scale=scale),
        "library_ms": lambda: torch.bmm(xs.transpose(1, 2), dys),
    }, dy_bytes=1, codes="int8"),
        lambda: xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale),
        lambda: torch.bmm(xs.transpose(1, 2), dys),
        xbk.outer_product_tile(T, M, K, N, 1))


def outer_product_cases() -> list[tuple[int, int, int, int]]:
    """(T, M, K, N) of the bit pins: every training stage stack at M = 1, 64
    and 4096, crossbar_apply's mnist layers at M = 4096, and the train
    phase's ragged shapes (its chip-axis case folded: 2 x 3 cores)."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [(T, M, K, N) for T, K, N in stacks for M in (1, 64, 4096)]
    cases += [(1, 4096, K, N) for K, N in MNIST_LAYERS]
    return cases + [(3, 37, 300, 26), (6, 7, 45, 13)]


def offset_copy(t: torch.Tensor, elements: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``elements`` elements into its
    buffer, so that its address is not 16-byte aligned."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


def differing(a: torch.Tensor, b: torch.Tensor) -> str:
    return f"{int((a != b).sum())} of {a.numel()} values differ"


def outer_product_phase(xbk, gen) -> dict:
    """Bit pins that tie the dw and pulse kernels (and, through the fused
    phase, crossbar_train.cu) to one summation order, at every
    ``outer_product_cases`` shape:
    (a) dw on int8 codes with a scale equals dw on ``codes.float() *
        scale``;
    (b) pulse_update equals the plain pulse epilogue
        (``pulse_epilogue_plain``: round(fp32(2 lr) dw / fp32(u)), clamp,
        0.5 (c u), g± ± half, clamp) applied to the dw kernel's product.
    Then every tile of ``OUTER_PRODUCT_TILES`` gives the picked tile's bits
    for dw (fp32, int8 and int32 codes) and pulse, on ragged shapes, on
    operands whose addresses are not 16-byte aligned, and at the largest
    main-path shape; the picked tile is held against the plain versions.
    Returns the pin counts.  Launches here are not counted."""
    rule = dict(max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    scale = torch.tensor(0.05 / 127, device="cuda")
    pins = {"a": 0, "b": 0, "tiles": 0}
    for T, M, K, N in outer_product_cases():
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        codes = torch.randint(-127, 128, (T, M, N), generator=gen,
                              dtype=torch.int8, device="cuda")
        got = xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale)
        want = xbk.crossbar_dw_kernel(xs, codes.float() * scale)
        if not torch.equal(got, want):
            raise AssertionError(f"pin (a) at {(T, M, K, N)}: dw on codes "
                                 f"vs dequantized, {differing(got, want)}")
        d = uniform((T, M, N), -0.05, 0.05, gen)
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        lr = 0.25 / M ** 0.5
        got = xbk.pulse_update_kernel(gp, gm, xs, d, lr=lr, **rule)
        want = xbk.pulse_epilogue_plain(
            gp, gm, xbk.crossbar_dw_kernel(xs, d), lr=lr, **rule)
        for name, a, b in zip(("g+", "g-"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"pin (b) at {(T, M, K, N)}: pulse vs "
                                     f"epilogue(dw) {name}, "
                                     f"{differing(a, b)}")
        pins["a"] += 1
        pins["b"] += 1
    for T, M, K, N, off in ((3, 37, 300, 26, 1), (2, 70, 17, 9, 3),
                            (6, 100, 400, 100, 2), (1, 4096, 784, 300, 0)):
        xs = offset_copy(uniform((T, M, K), -0.5, 0.5, gen), off)
        d = offset_copy(uniform((T, M, N), -0.05, 0.05, gen), off)
        c8 = offset_copy(torch.randint(-127, 128, (T, M, N), generator=gen,
                                       dtype=torch.int8, device="cuda"),
                         5 * off)
        c32 = offset_copy(c8.to(torch.int32), off)
        gp = uniform((T, K, N), 0.3, 0.7, gen)
        gm = uniform((T, K, N), 0.3, 0.7, gen)
        lr = 0.25 / M ** 0.5
        runs = {
            "dw fp32": lambda t: (xbk.crossbar_dw_kernel(xs, d, tile=t),),
            "dw int8": lambda t: (xbk.crossbar_dw_kernel(
                xs, c8, dy_scale=scale, tile=t),),
            "dw int32": lambda t: (xbk.crossbar_dw_kernel(
                xs, c32, dy_scale=scale, tile=t),),
            "pulse": lambda t: xbk.pulse_update_kernel(
                gp, gm, xs, d, lr=lr, tile=t, **rule),
        }
        ref = {k: f(None) for k, f in runs.items()}
        what = f"{(T, M, K, N)} offset {off}"
        close(ref["dw fp32"][0], xbk.crossbar_dw_plain(xs, d),
              f"dw {what}")
        close(ref["dw int8"][0], xbk.crossbar_dw_plain(xs, c8,
                                                        dy_scale=scale),
              f"dw int8 {what}")
        if not torch.equal(ref["dw int8"][0], ref["dw int32"][0]):
            raise AssertionError(f"dw int8 vs int32 codes {what}")
        counts = xbk.pulse_counts_plain(xs, d, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        check_pulse_counts(gp, gm, ref["pulse"],
                           xbk.pulse_update_plain(gp, gm, xs, d, lr=lr,
                                                  **rule),
                           counts, f"pulse {what}")
        for t in range(len(xbk.OUTER_PRODUCT_TILES)):
            for name, run in runs.items():
                for a, b in zip(run(t), ref[name]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} {what}: tile {t} vs "
                                             f"the picked tile, "
                                             f"{differing(a, b)}")
                pins["tiles"] += 1
    torch.cuda.synchronize()
    print(f"outer-product pins: (a) dw(codes, scale) == dw(codes * scale) "
          f"and (b) pulse == epilogue(dw), bit for bit, at {pins['a']} "
          f"shapes; every tile == the picked tile at {pins['tiles']} "
          f"(kernel, shape, tile) triples")
    return pins


def tile_sweep(xbk, gen) -> list[dict]:
    """Device time (``graph_ms``) of every tile at the main paths' dw and
    pulse launches: crossbar_apply's 4 mnist layers on int8 codes at M =
    4096, one eager mnist step's stacks at M = 4096 and isolet's at M =
    256; beside the tile the wrapper picks."""
    rule = dict(lr=LR, max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    scale = torch.tensor(0.05 / 127, device="cuda")
    shapes = [("crossbar_dw", 1, 4096, K, N) for K, N in MNIST_LAYERS]
    shapes += [("pulse_update", T, M, K, N) for app, M in
               (("mnist_class", 4096), ("isolet_class", 256))
               for T, K, N in dict.fromkeys(TRAIN_SHAPES[app])]
    rows = []
    for kernel, T, M, K, N in shapes:
        xs = uniform((T, M, K), -0.5, 0.5, gen)
        if kernel == "crossbar_dw":
            codes = torch.randint(-127, 128, (T, M, N), generator=gen,
                                  dtype=torch.int8, device="cuda")
            def run(t):
                return xbk.crossbar_dw_kernel(xs, codes, dy_scale=scale,
                                              tile=t)
        else:
            d = uniform((T, M, N), -0.05, 0.05, gen)
            gp = uniform((T, K, N), 0.3, 0.7, gen)
            gm = uniform((T, K, N), 0.3, 0.7, gen)
            def run(t):
                return xbk.pulse_update_kernel(gp, gm, xs, d, tile=t, **rule)
        ms = [graph_ms(lambda: run(t)) for t in
              range(len(xbk.OUTER_PRODUCT_TILES))]
        picked = xbk.outer_product_tile(T, M, K, N, 1 if kernel ==
                                        "crossbar_dw" else 4)
        rows.append({"kernel": kernel, "T": T, "M": M, "K": K, "N": N,
                     "picked": picked, "best": ms.index(min(ms)),
                     "ms_by_tile": [round(v, 5) for v in ms]})
    return rows


def outer_product_ptxas(report: dict[str, dict]) -> dict[str, list]:
    """Registers, spill bytes (stores + loads) and dynamic shared memory of
    every dw and pulse instance, by kernel, tile and dy type; raises on a
    spill."""
    import re
    from repro_torch.kernels import crossbar as xbk
    out = {}
    pat = re.compile(r"(crossbar_dw|pulse_update)IN13outer_product4Tile"
                     + r"ELi".join([r"ILi(\d+)"] + [r"(\d+)"] * 5)
                     + r"EEE?([afi]?)")
    for key, v in report.items():
        m = pat.search(key)
        if not m:
            continue
        tk, tn, wk, wn, bm, stages = map(int, m.groups()[1:7])
        td = {"": "f32", "f": "f32", "a": "int8", "i": "int32"}[m.group(8)]
        bk, bn = 8 * tk * wk, 4 * tn * wn
        raw = bm * ((bn + 15) // 16 * 16 + 16) if td == "int8" else 0
        tile = xbk.OUTER_PRODUCT_TILES.index((tk, tn, wk, wn, bm, stages))
        spills = v.get("spill_stores", 0) + v.get("spill_loads", 0)
        if spills:
            raise AssertionError(f"{key}: {spills} bytes of register spills")
        stage = -(-(4 * bm * (bk + bn) + raw) // 128) * 128
        out[f"{m.group(1)}[{tile}] {td}"] = [
            v.get("registers"), spills, stages * (stage + 16)]
    if len(out) != 4 * len(xbk.OUTER_PRODUCT_TILES):
        raise AssertionError(f"ptxas report: {len(out)} dw/pulse instances")
    return dict(sorted(out.items()))


def fused_kernel_cases() -> list[dict]:
    """Fused-kernel cases: every training stage stack at M = 1, 64, 4096,
    and tests/test_compiled_step.py's megakernel shapes (ragged stacks with
    zeroed trailing cores, int8 codes), a chip axis, codes at full size."""
    stacks = sorted({s for v in TRAIN_SHAPES.values() for s in v})
    cases = [dict(shape=(T, M, K, N)) for T, K, N in stacks
             for M in (1, 64, 4096)]
    cases += [dict(shape=(1, 2, 17, 9)), dict(shape=(3, 4, 41, 15)),
              dict(shape=(4, 2, 400, 100), ragged=2),
              dict(shape=(3, 4, 41, 15), codes=True),
              dict(shape=(5, 3, 129, 101), codes=True, ragged=3),
              dict(shape=(3, 7, 45, 13), chips=2, codes=True),
              dict(shape=(6, 4096, 400, 100), codes=True)]
    return cases


def fused_kernel_phase(xbk, ops, gen) -> tuple[float, list[dict]]:
    """The fused training kernel against the four-call sequence (bit for
    bit) and against its plain version; returns (max |kernel - plain| of
    ys and dxs, timing rows at M = 4096)."""
    max_err, rows, flips = 0.0, [], 0
    cases = fused_kernel_cases()
    rule = dict(max_dw=MAX_DW, levels=LEVELS, w_max=W_MAX)
    for case in cases:
        T, M, K, N = case["shape"]
        lead = (case["chips"],) if "chips" in case else ()
        xs = uniform(lead + (T, M, K), -0.5, 0.5, gen)
        gp = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        gm = uniform(lead + (T, K, N), 0.3, 0.7, gen)
        scale = None
        if case.get("codes"):
            dys = torch.randint(-127, 128, lead + (T, M, N), generator=gen,
                                dtype=torch.int8, device="cuda")
            scale = torch.tensor(0.05 / 127, device="cuda")
        else:
            dys = uniform(lead + (T, M, N), -0.05, 0.05, gen)
        if case.get("ragged"):   # the envelope's zeroed trailing cores
            for a in (xs, gp, gm, dys):
                a[..., T - case["ragged"]:, :, :] = 0
        d = dys if scale is None else dys.float() * scale
        lr = 0.25 / M ** 0.5
        lr_t = torch.full((1,), lr, device="cuda")
        gpi, gmi = gp.clone(), gm.clone()
        if lead:   # through the wrapper's chip-axis fold
            got = ops.crossbar_train_stacked(gp, gm, xs, dys, lr=lr_t,
                                             dy_scale=scale, compute_y=True,
                                             **rule)
            dxi = ops.crossbar_train_stacked(gpi, gmi, xs, dys, lr=lr_t,
                                             dy_scale=scale, inplace=True,
                                             **rule)[1]
            got = [a.reshape((-1,) + a.shape[2:]) for a in got]
            dxi, xs, d, dys, gp, gm, gpi, gmi = (
                a.reshape((-1,) + a.shape[2:])
                for a in (dxi, xs, d, dys, gp, gm, gpi, gmi))
        else:
            got = xbk.crossbar_train_kernel(gp, gm, xs, dys, lr=lr_t,
                                            dy_scale=scale, compute_y=True,
                                            **rule)
            dxi = ops.crossbar_train_stacked(gpi, gmi, xs, dys, lr=lr_t,
                                             dy_scale=scale, inplace=True,
                                             **rule)[1]
        four = (xbk.crossbar_fwd_kernel(xs, gp, gm, activation=False),
                xbk.crossbar_bwd_kernel(d, gp, gm),
                *xbk.pulse_update_kernel(gp, gm, xs, d, lr=lr, **rule))
        torch.cuda.synchronize()
        what = f"fused {case} lr={lr:.4g}"
        for name, a, b in zip(("ys", "dxs", "g+", "g-"), got, four):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"four-call sequence")
        for name, a, b in (("in-place dxs", dxi, four[1]),
                           ("in-place g+", gpi, four[2]),
                           ("in-place g-", gmi, four[3])):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs from the "
                                     f"four-call sequence")
        want = xbk.crossbar_train_plain(gp, gm, xs, dys, lr=lr,
                                        dy_scale=scale, compute_y=True,
                                        **rule)
        max_err = max(max_err, close(got[0], want[0], f"{what} ys"),
                      close(got[1], want[1], f"{what} dxs"))
        counts = xbk.pulse_counts_plain(xs, d, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        flips += check_pulse_counts(gp, gm, got[2:], want[2:], counts, what)
        if M == 4096 and not lead and scale is None:
            rows.append(time_fused_shape(xbk, xs, d, gp, gm, lr))
    print(f"fused kernel phase: {len(cases)} cases x (forward on; forward "
          f"off, copied in place), bit for bit equal to the "
          f"four-call sequence; max |kernel - plain| {max_err:.3e} (ys, "
          f"dxs), {flips} pulse counts one apart at a half-integer")
    return max_err, rows


def time_fused_shape(xbk, xs, ds, gp, gm, lr) -> dict:
    """Kernel (forward off, as in the compiled step) / plain / ``torch.bmm``
    for dx plus ``torch.bmm`` for dw, on one stage stack."""
    T, M, K = xs.shape
    N = ds.shape[2]
    lr_t = torch.full((1,), lr, device="cuda")
    xt = xs.transpose(1, 2)
    return time_row("crossbar_train", T, M, K, N, {
        "ms": lambda: xbk.crossbar_train_kernel(gp, gm, xs, ds, lr=lr_t),
        "plain_ms": lambda: xbk.crossbar_train_plain(gp, gm, xs, ds, lr=lr),
        "library_ms": lambda: (torch.bmm(ds, (gp - gm).transpose(1, 2)),
                               torch.bmm(xt, ds)),
    }, library="bmm for dx + bmm for dw, without the pulse epilogue")


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


def chip_stage_inputs(chip, entries) -> list[dict]:
    """Per layer, the chip's own stage inputs read back from its update
    launches — ``entries`` holds each stage's (core inputs xs, core errors
    ds, lr), last stage first: input activations (core i*c holds fan-in
    tile i), local errors (core j holds fan-out tile j) and the unrounded
    pulse counts of the plain rule on them."""
    from repro_torch.kernels import crossbar as xbk
    out = [None] * len(chip.placement.stages)
    for (xs, ds, lr), st in zip(entries, reversed(chip.placement.stages)):
        r, c = st.row_tiles, st.col_tiles
        counts = xbk.pulse_counts_plain(xs, ds, lr=lr, max_dw=MAX_DW,
                                        levels=LEVELS)
        out[st.index] = {
            "act": torch.cat([xs[i * c] for i in range(r)],
                             dim=1)[:, 1:st.lmap.fan_in + 1],
            "local": torch.cat([ds[j] for j in range(c)],
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
    ours = chip_stage_inputs(chip, [(a[2], a[3], kw["lr"])
                                    for a, kw, _ in pulse])
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
    mnist = build_chip("mnist_class", seed=SEED, device="cuda",
                       compiled=False)
    isolet = build_chip("isolet_class", seed=SEED, device="cuda",
                        compiled=False)
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


# ---------------------------------------------------------------------------
# Compiled paths (the chip's default: one captured CUDA graph per shape)
# ---------------------------------------------------------------------------

WRAPPERS = ("crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
            "crossbar_fwd_stacked", "crossbar_bwd_stacked",
            "crossbar_dw_stacked", "pulse_update_stacked",
            "crossbar_train_stacked")


def zero_counts(ops, csim) -> None:
    """Every wrapper's launch count and the capture count to 0."""
    for n in WRAPPERS:
        getattr(ops, n).launches = 0
    csim.reset_capture_counts()


def read_counts(ops) -> dict[str, int]:
    return {n: getattr(ops, n).launches for n in WRAPPERS
            if getattr(ops, n).launches}


def per_replay(chips: dict) -> dict[str, dict]:
    """Each built program's kernel launches per replay, by chip and key."""
    return {f"{app} {key[0]} {key[2]}": prog.per_replay
            for app, chip in chips.items()
            for key, prog in chip._get_stacks().programs.items()}


def check_against_eager(chip_c, chip_e, x, out_c, out_e) -> int:
    """A compiled wave against the eager chip's on the same conductances:
    stage inputs as 3-bit codes (a flip only at a boundary), dot products
    and outputs within ATOL on every sample not past a flip.  Returns the
    samples past a flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    ac, dc, _ = chip_c.forward_wave(x, count=False)
    ae, de, _ = chip_e.forward_wave(x, count=False)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(len(dc)):
        if s:
            flipped |= code_flips(hard_sigmoid(de[s - 1]), ac[s])
        off = ((dc[s] - de[s]).abs() > ATOL).any(dim=-1)
        if bool((off & ~flipped).any()):
            raise AssertionError(f"{chip_c.name}: stage {s} dot products "
                                 f"differ from eager off a code flip")
    off = ((out_c - out_e).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip_c.name}: compiled output differs from "
                             f"eager on a sample with no boundary flip")
    return int(flipped.sum())


def compiled_recognition(ops, csim, build_chip, mlp_forward, hw, eager,
                         waves) -> tuple[dict, dict]:
    """The compiled recognition path (module docstring, step 5): each wave
    of ``waves`` ((app, x, eager output)) twice on a compiled chip.
    Returns (chips, launch counts)."""
    chips = {app: build_chip(app, seed=SEED, device="cuda")
             for app in ("mnist_class", "isolet_class")}
    zero_counts(ops, csim)
    outs = []
    for app, x, _ in waves:
        first, _ = chips[app].infer_stream(x)     # capture
        outs.append((first, chips[app].infer_stream(x)[0]))   # replay
    torch.cuda.synchronize()
    launches, captures = read_counts(ops), csim.capture_counts()
    if launches != {"crossbar_fwd_stacked": 2 * (4 + 4 + 5)}:
        raise AssertionError(f"compiled recognition launches {launches}, "
                             f"expected 4 per mnist wave and 5 per isolet "
                             f"wave, 2 waves per shape")
    if len(captures) != len(waves) or set(captures.values()) != {1}:
        raise AssertionError(f"captures {captures}: expected one per shape")
    replays = per_replay(chips)
    for name, got in replays.items():
        want = 4 if name.startswith("mnist") else 5
        if got != {"crossbar_fwd_stacked": want}:
            raise AssertionError(f"{name}: {got} per replay")
    flips = {}
    for (app, x, out_e), (first, replay) in zip(waves, outs):
        if not torch.equal(first, replay):
            raise AssertionError(f"{app}: a replay differs from its first "
                                 f"run")
        what = f"{app} x{x.shape[0]}"
        flips[f"{what} vs plain"] = check_chip_wave(
            chips[app], x, replay, mlp_forward, chips[app].spec)
        flips[f"{what} vs eager"] = check_against_eager(
            chips[app], eager[app], x, replay, out_e)
    print(f"compiled recognition path: launches {json.dumps(launches)} "
          f"(4 per mnist wave x 4, 5 per isolet wave x 2), "
          f"{len(captures)} captures, one per (program, shape); per replay "
          + json.dumps(replays))
    print("compiled waves held against plain and eager (samples after a "
          "boundary code flip): " + json.dumps(flips))
    for chip in chips.values():
        cmp_ = check_report(chip, hw)
        print(f"{chip.name} compiled: beat {chip.beat_us:.4f} us, hw_model "
              "rel err " + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    return chips, launches


class GraphRecorder:
    """Stands in for ``kernels.ops`` inside ``sim.compiled`` and keeps what
    the fused wrapper read and wrote: (xs, ds, lr, dxs) per stage.  A
    program's first call runs the stage loop for real (its entries hold
    that call's values); its capture's entries are the graph's own memory,
    which every replay rewrites, so after a replay they hold that replay's
    stage inputs.  It launches nothing itself."""

    def __init__(self, ops):
        self._ops = ops
        self.run, self.captured = [], []

    def __getattr__(self, name):
        fn = getattr(self._ops, name)
        if name != "crossbar_train_stacked":
            return fn

        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            capturing = torch.cuda.is_current_stream_capturing()
            (self.captured if capturing else self.run).append(
                (args[2], args[3], kwargs["lr"], out[1]))
            return out
        return record


def stage_stacks(chip) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(st.g_plus.clone(), st.g_minus.clone())
            for st in chip.placement.stages]


def stacks_to_layers(stacks, chip) -> list[dict[str, torch.Tensor]]:
    return [{"g_plus": untile(gp, st), "g_minus": untile(gm, st)}
            for (gp, gm), st in zip(stacks, chip.placement.stages)]


def check_compiled_step(chip, ours_c, ours_e, layers0, layers_c, layers_e,
                        x, target, err_c, err_e, spec, lr) -> dict:
    """Hold a compiled step against the eager chip's step from the same
    conductances, under the tolerances of ``check_train_step``: forward
    codes and 8-bit error codes may flip only at their boundaries, and a
    pulse count may differ by one next to a half-integer or where the two
    sides' own inputs round apart downstream of such a flip."""
    from repro_torch.core.crossbar import hard_sigmoid
    S = len(layers0)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for s in range(1, S):
        w = layers0[s - 1]["g_plus"] - layers0[s - 1]["g_minus"]
        for ours in (ours_c, ours_e):
            flipped |= code_flips(hard_sigmoid(ours[s - 1]["act"] @ w),
                                  ours[s]["act"])
    plain = plain_rule(layers0, x, target, spec, lr)
    err_flips = 0
    for s in reversed(range(S)):
        off = (ours_c[s]["local"] - ours_e[s]["local"]).abs() > ATOL
        off &= ~flipped[:, None]
        if bool(off.any()):
            r = plain[s]["ratio"][off]
            if bool(((r - torch.floor(r) - 0.5).abs() > 1e-3).any()):
                raise AssertionError(f"{chip.name}: layer {s} local error "
                                     f"differs off an 8-bit code boundary")
            err_flips = int(off.sum())
            break
    off = ((err_c - err_e).abs() > ATOL).any(dim=-1)
    if bool((off & ~flipped).any()):
        raise AssertionError(f"{chip.name}: compiled step error differs "
                             f"from eager off a code flip")
    differ = bool(flipped.any()) or err_flips > 0
    step_flips = 0
    for li in range(S):
        counts = ours_e[li]["counts"]
        if differ:
            apart = (torch.round(ours_c[li]["counts"])
                     != torch.round(counts))
            counts = torch.where(apart, torch.full_like(counts, 0.5), counts)
        step_flips += check_conductances(
            (layers_c[li]["g_plus"], layers_c[li]["g_minus"]),
            (layers_e[li]["g_plus"], layers_e[li]["g_minus"]), counts,
            f"{chip.name} compiled step layer {li} vs eager")
    return {"step_pulse_flips": step_flips,
            "fwd_code_flip_samples": int(flipped.sum()),
            "err_code_flips": err_flips}


def compiled_train_path(ops, csim, chip_mod, build_chip, spec, hw,
                        gen) -> dict:
    """The compiled training path (module docstring, step 7)."""
    from repro_torch.kernels import crossbar as xbk
    apps = ("mnist_class", "isolet_class")
    chips = {a: build_chip(a, seed=SEED, device="cuda") for a in apps}
    eager = {a: build_chip(a, seed=SEED, device="cuda", compiled=False)
             for a in apps}
    for chip in (*chips.values(), *eager.values()):
        # one counted wave each, so compare_hw has its infer keys
        chip.infer(uniform((4, chip.placement.dims[0]), -0.5, 0.5, gen))
    data = [(app, uniform((B, chips[app].placement.dims[0]), -0.5, 0.5, gen),
             uniform((B, chips[app].placement.dims[-1]), -0.5, 0.5, gen),
             lr) for app, B, lr in STEPS]
    ptrs = {a: (c._get_stacks().g_plus.data_ptr(),
                c._get_stacks().g_minus.data_ptr())
            for a, c in chips.items()}
    rec = GraphRecorder(ops)
    graphs, records = {}, []
    csim.kernel_ops = rec
    try:
        zero_counts(ops, csim)
        for app, x, t, lr in data:
            chip = chips[app]
            S = len(chip.placement.stages)
            before, n_run, n_cap = stage_stacks(chip), len(rec.run), \
                len(rec.captured)
            err = chip.train_step(x, t, lr=lr)
            if len(rec.run) > n_run:    # this call built its program
                entries = rec.run[n_run:n_run + S]
                graphs[(app, x.shape[0])] = rec.captured[n_cap:n_cap + S]
            else:                       # a replay: read the graph's memory
                entries = graphs[(app, x.shape[0])]
            entries = [tuple(a.clone() for a in e) for e in entries]
            records.append((app, x, t, lr, before, entries, err.clone(),
                            stage_stacks(chip)))
        torch.cuda.synchronize()
        launches, captures = read_counts(ops), csim.capture_counts()
    finally:
        csim.kernel_ops = ops
    expect = 4 * 5 + 5
    if launches != {"crossbar_fwd_stacked": expect,
                    "crossbar_train_stacked": expect}:
        raise AssertionError(f"compiled training launches {launches}, "
                             f"expected {expect} fwd and {expect} fused")
    if sorted(k[2] for k in captures) != [(1, 784), (256, 617),
                                          (4096, 784)] \
            or set(captures.values()) != {1}:
        raise AssertionError(f"captures {captures}: expected one per batch "
                             f"(the lr change must not recapture)")
    after = {a: (c._get_stacks().g_plus.data_ptr(),
                 c._get_stacks().g_minus.data_ptr())
             for a, c in chips.items()}
    if after != ptrs:
        raise AssertionError(f"the envelope moved: {ptrs} -> {after}")
    replays = {k: v for k, v in per_replay(chips).items() if "train" in k}
    print(f"compiled training path: launches {json.dumps(launches)} (4 + 4 "
          f"per mnist step x 5, 5 + 5 per isolet step), captures "
          + json.dumps({f"{k[0]} {k[2]}": v for k, v in captures.items()})
          + " (lr halved before the third batch-1 step), per replay "
          + json.dumps(replays) + f"; envelope data_ptr (g+, g-) before "
          f"{json.dumps(ptrs)} after {json.dumps(after)}")
    # stage by stage and against eager, outside the counted run
    erec = Recorder(ops)
    chip_mod.kernel_ops = erec
    results, stage_flips = [], 0
    try:
        for app, x, t, lr, before, entries, err, after_st in records:
            chip, ech = chips[app], eager[app]
            for (xs, ds, lr_t, dxs), st in zip(
                    entries, reversed(chip.placement.stages)):
                gp0, gm0 = before[st.index]
                close(dxs, xbk.crossbar_bwd_plain(ds, gp0, gm0),
                      f"{app} compiled stage {st.index} dx")
                want = xbk.pulse_update_plain(
                    gp0, gm0, xs, ds, lr=lr_t, max_dw=MAX_DW,
                    levels=LEVELS, w_max=W_MAX)
                counts = xbk.pulse_counts_plain(xs, ds, lr=lr_t,
                                                max_dw=MAX_DW, levels=LEVELS)
                stage_flips += check_conductances(
                    after_st[st.index], want, counts,
                    f"{app} compiled stage {st.index} g±")
            for s, (gp, gm) in enumerate(before):
                ech.placement.set_stage_stacks(s, gp.clone(), gm.clone())
            n = len(erec.calls["pulse_update_stacked"])
            err_e = ech.train_step(x, t, lr=lr)
            pulse = erec.calls["pulse_update_stacked"][n:]
            ours_e = chip_stage_inputs(ech, [(a[2], a[3], kw["lr"])
                                             for a, kw, _ in pulse])
            ours_c = chip_stage_inputs(chip, [e[:3] for e in entries])
            results.append(check_compiled_step(
                chip, ours_c, ours_e, stacks_to_layers(before, chip),
                stacks_to_layers(after_st, chip), clone_layers(ech), x, t,
                err, err_e, spec, lr))
        torch.cuda.synchronize()
    finally:
        chip_mod.kernel_ops = ops
    print(f"compiled training steps held against plain per stage "
          f"({stage_flips} pulse counts one apart at a half-integer) and "
          f"against eager (batch 1 x3, 4096 x2 mnist; 256 isolet): "
          + json.dumps(results))
    keys = {"infer_time", "infer_energy", "infer_io", "train_time",
            "train_energy", "train_io"}
    for chip in chips.values():
        cmp_ = chip.report().compare_hw(
            hw.network_cost(chip.name, list(chip.placement.dims)))
        if set(cmp_) != keys or not all(v <= 0.01 for v in cmp_.values()):
            raise AssertionError(f"{chip.name}: hw_model cross-validation "
                                 f"{cmp_}")
        print(f"{chip.name} compiled, after training: hw_model rel err "
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


# ---------------------------------------------------------------------------
# k-means kernel phase and the paper-apps path (autoencoder dimensionality
# reduction -> k-means -> anomaly detection)
# ---------------------------------------------------------------------------

FP32_INSTR_S = 33.5e12   # fp32 adds per second: half the 67 TFLOP/s FMA rate
NEAR_TIE = 1e-5          # argmin flips allowed only where two distances are
                         # this close (relative, recomputed in float64)
# (n, d, k, what) of the kernel phase
KMEANS_CASES = [
    (2048, 20, 10, "clustering path (mnist_dimred features)"),
    (60000, 20, 10, "MNIST training-set size"),
    (2048, 20, 26, "isolet's 26 classes"),
    (65536, 32, 32, "the hardware core's 32 x 32 limit"),
    (65536, 128, 128, "the TPU tile limit"),
    (513, 10, 5, "ragged"),
    (4096, 20, 1, "k = 1"),
    (4096, 20, 30, "duplicated centers (10 centers 3 times)"),
]
APPS_PRETRAIN_EPOCHS = 2   # mnist_dimred pretraining (depth not cut)
APPS_ANOMALY_EPOCHS = 3    # kdd_anomaly pretraining


def kmeans_bound(n, d, k) -> tuple[float, float]:
    """(ms at the fp32 add rate, ms at the HBM rate) of one assignment:
    2 n k d operations (subtract, add with |.| as a modifier); x, centers
    read once, the int32 assignment written once."""
    return (2.0 * n * k * d / FP32_INSTR_S * 1e3,
            4.0 * (n * d + k * d + n) / HBM_BYTES_S * 1e3)


def near_tie_flips(x, c, got, want, what) -> int:
    """Assignments equal, except where the two smallest distances of a
    sample (float64) lie within NEAR_TIE relative and each side picked
    one of those two centers.  Returns the number of such samples."""
    off = torch.nonzero(got.long() != want.long()).flatten()
    if off.numel() == 0:
        return 0
    d = (x[off, None, :].double() - c[None, :, :].double()).abs().sum(-1)
    two = torch.sort(d, dim=1).values[:, :2]
    gap = (two[:, 1] - two[:, 0]) / two[:, 1].clamp(min=1e-30)
    rows = torch.arange(off.numel(), device=x.device)
    picked_ok = all(bool((d[rows, a[off].long()] <= two[:, 1]).all())
                    for a in (got, want))
    if bool((gap > NEAR_TIE).any()) or not picked_ok:
        raise AssertionError(f"{what}: {off.numel()} assignments differ, "
                             f"largest relative gap {float(gap.max()):.3e}")
    return int(off.numel())


def kmeans_kernel_phase(kmk, gen) -> tuple[int, list[dict]]:
    """The k-means kernel against its plain version at KMEANS_CASES, timed
    (CUDA events, and its device time under the profiler) beside the plain
    version, ``torch.cdist(p=1).argmin`` and the bound; returns (near-tie
    flips, rows).  Launches here are not counted."""
    flips, rows = 0, []
    for n, d, k, what in KMEANS_CASES:
        x = uniform((n, d), -0.5, 0.5, gen)
        if what.startswith("duplicated"):
            c = x[:10].repeat(3, 1).contiguous()   # exact ties, rows of x
        else:
            c = uniform((k, d), -0.5, 0.5, gen)
        got = kmk.kmeans_assign_kernel(x, c)
        want = kmk.kmeans_assign_plain(x, c)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != (n,):
            raise AssertionError(f"kmeans_assign {what}: {got.dtype} "
                                 f"{tuple(got.shape)}")
        case_flips = near_tie_flips(x, c, got, want,
                                    f"kmeans_assign {what}")
        if what.startswith("duplicated") and bool((got >= 10).any()):
            raise AssertionError("kmeans_assign: an exact tie did not go to "
                                 "the lowest index")
        if k == 1 and bool((got != 0).any()):
            raise AssertionError("kmeans_assign: k = 1 gave a nonzero index")
        flips += case_flips
        op_ms, byte_ms = kmeans_bound(n, d, k)
        rows.append({
            "kernel": "kmeans_assign", "n": n, "d": d, "k": k, "case": what,
            "near_tie_flips": case_flips,
            "ms": cuda_ms(lambda: kmk.kmeans_assign_kernel(x, c)),
            "device_ms": next(
                t["ms"] for t in profile_device(
                    lambda: kmk.kmeans_assign_kernel(x, c), reps=20)["top"]
                if "kmeans_assign" in t["kernel"]),
            "plain_ms": cuda_ms(lambda: kmk.kmeans_assign_plain(x, c)),
            "library_ms": cuda_ms(
                lambda: torch.cdist(x, c, p=1).argmin(1)),
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"})
    print(f"kmeans kernel phase: {len(KMEANS_CASES)} cases, assignments "
          f"equal to plain except {flips} near-tie flips (two distances "
          f"within {NEAR_TIE} relative); exact ties to the lowest index")
    return flips, rows


def purity(assign: torch.Tensor, labels: torch.Tensor, k: int) -> float:
    a, lab = assign.long().cpu(), labels.long().cpu()
    return sum(int(torch.bincount(lab[a == c]).max())
               for c in range(k) if bool((a == c).any())) / len(lab)


def paper_apps_path(ops) -> dict:
    """The paper-apps path at full width (module docstring, step 9):
    mnist_dimred pretraining -> encode -> k-means++ -> kmeans_fit on the
    kernel, then kdd_anomaly scoring.  Draws come from a CPU generator
    (``SEED``), the same on every device.  Returns the launch count, the
    stage times and the path's numbers."""
    from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
    from repro_torch.core import anomaly, autoencoder as ae, kmeans
    from repro_torch.data import synthetic as syn

    g = torch.Generator().manual_seed(SEED)
    x, labels = syn.mnist_like(g, 2048, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ops.kmeans_assign.launches = 0
    marks[0].record()
    enc_layers, curves = ae.pretrain_stack(
        g, x, NETWORKS["mnist_dimred"], PAPER_SPEC, lr=0.05,
        epochs=APPS_PRETRAIN_EPOCHS, batch=16)
    marks[1].record()
    feats = ae.encode(enc_layers, x, PAPER_SPEC)
    marks[2].record()
    init = kmeans.init_plusplus(g, feats, 10)
    centers, assign, inertia = kmeans.kmeans_fit(feats, init, epochs=15,
                                                 use_kernel=True)
    marks[3].record()
    fit_launches = ops.kmeans_assign.launches
    again = kmeans.assign(feats, centers, use_kernel=True)
    normal, attack = syn.kdd_like(g, 4096, 1024, device="cuda")
    enc, dec, ae_losses = ae.pretrain_layer(
        g, normal, *NETWORKS["kdd_anomaly"][:2], PAPER_SPEC, lr=0.03,
        epochs=APPS_ANOMALY_EPOCHS, batch=16)
    s_n = anomaly.reconstruction_error([enc, dec], normal, PAPER_SPEC)
    s_a = anomaly.reconstruction_error([enc, dec], attack, PAPER_SPEC)
    marks[4].record()
    torch.cuda.synchronize()
    launches = ops.kmeans_assign.launches
    if (fit_launches, launches) != (1, 2):
        raise AssertionError(f"kmeans_assign launches: {fit_launches} in "
                             f"kmeans_fit, {launches} in all; expected one "
                             f"per kernel-routed call (1, 2)")
    if feats.shape != (2048, 20) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"features {tuple(feats.shape)} not finite")
    if not torch.equal(again, assign):
        raise AssertionError("two launches on the same inputs differ")
    flips = near_tie_flips(feats, centers, assign,
                           kmeans.assign(feats, centers), "kmeans_fit")
    rises = torch.diff(inertia)
    if bool((rises > 1e-3).any()):
        raise AssertionError(f"inertia rose by {float(rises.max())}")
    for what, t in (("pretraining losses", torch.cat(curves)),
                    ("anomaly losses", ae_losses), ("normal scores", s_n),
                    ("attack scores", s_a), ("centers", centers)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"paper-apps path: {what} not finite")
    det = anomaly.detection_at_fpr(s_n, s_a, max_fpr=0.04)
    auc = anomaly.auc(s_n, s_a)
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]
    out = {
        "kmeans_assign launches": launches, "near_tie_flips": flips,
        "purity": purity(assign, labels, 10),
        "inertia first, last": [float(inertia[0]), float(inertia[-1])],
        "pretrain loss per layer, first -> last epoch": [
            [float(c[0]), float(c[-1])] for c in curves],
        "anomaly detection at 4% FPR": det, "anomaly AUC": auc,
        "ms": {"pretrain_stack 784-300-200-100-20": ms[0],
               "encode": ms[1], "init_plusplus + kmeans_fit": ms[2],
               "assign + kdd_anomaly draw, pretrain, scoring": ms[3]}}
    print(f"paper-apps path: kmeans_assign launches {launches} (1 in "
          f"kmeans_fit(use_kernel=True), 1 in assign(use_kernel=True)); "
          f"kernel vs plain assign on the fitted centers: {flips} near-tie "
          f"flips; inertia non-increasing; purity {out['purity']:.4f}; "
          f"detection at 4% FPR {det * 100:.2f}% (paper: 96.6%), AUC "
          f"{auc:.4f}")
    print("paper-apps path: " + json.dumps(out))
    return out


# -- the LM serving path (qwen2-0.5b at full width) and the flash kernel ----

FA_TOL = 2e-5            # fp32 kernel vs plain: the reference's kernel bar
# (B, S, H, K, hd, causal, dtype, what) of the flash kernel phase
FLASH_CASES = [
    (4, 2048, 14, 2, 64, True, "bfloat16", "qwen2-0.5b prefill"),
    (4, 2048, 14, 2, 64, True, "float32", "qwen2-0.5b prefill, fp32"),
    (1, 4096, 32, 4, 128, True, "bfloat16", "yi-6b heads"),
    (2, 1000, 14, 2, 64, True, "bfloat16", "ragged S = 1000"),
    (2, 384, 8, 2, 64, False, "float32", "non-causal"),
    (2, 512, 8, 8, 64, True, "float32", "MHA (G = 1)"),
    (2, 64, 4, 2, 16, True, "float32", "test_kernels shape 1"),
    (1, 128, 2, 1, 32, True, "float32", "test_kernels shape 2"),
    (2, 64, 4, 4, 16, False, "float32", "test_kernels shape 3"),
    (1, 256, 2, 2, 64, True, "float32", "test_kernels shape 4"),
]
LM_ARCH = "qwen2-0.5b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SERVE_BATCH, SERVE_MAX_LEN, SERVE_NEW = 4, 256, 32
# decode logits against prefill logits at full width: bf16 compute and
# cache, every product's output rounded to bf16 (a step of 2^-6 at
# |logit| in [2, 4)) and summed in other orders through 24 layers: 8 such
# steps.  float32 compute and cache, TF32 off: summation order only.
LOGIT_BAR = {"bfloat16": 0.125, "float32": 1e-3}


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_flash(got, want, dtype, what, semantics="pallas",
                wam=None) -> float:
    """Hold a flash kernel's output against its plain version; raises
    unless every |got - want| is within the bar, returns the largest.

    fp32: FA_TOL (1 + |want|), the reference's kernel bar.  bf16, the
    Pallas function: one bf16 step at max(|got|, |want|), plus 1e-6: both
    sides hold p to 24 bits (the tensor-core kernel as three bf16 terms)
    and round an fp32 value once.

    bf16, the chunked function against the plain version at 512-key
    chunks: one bf16 step at max(|got|, |want|) plus 2^-8 wam, wam =
    sum_j p_j |v_j| / l from the plain side in fp32.  Both sides compute
    o = sum_j bf16(p~_j) v_j / l with p~_j = exp(s_j - m'), m' the running
    max when key j's block is reached.  The kernel's block is 64 keys and
    this plain version's chunk 512, so m' and with it the rounding of p~_j
    differ; each rounding is within half a bf16 step, at most 2^-8 p~_j,
    so after the exact rescaling to the final max the two p_j differ by
    at most 2^-7 p_j.  Those errors have independent signs from key to
    key, so the two fp32 outputs differ by far less than 2^-7 wam; the
    run prints the largest excess over one step as a share of wam (the
    margin under 2^-8).  Each side then rounds to bf16, at most half a
    step at its own magnitude: one step at the larger, in all.  Random
    inputs make |o| small beside wam, so a bar in steps of |o| alone would
    be wrong.  This bar cannot tell the two functions apart (rounding p
    moves o by about as much); ``check_chunked_tile`` and
    ``check_functions`` do."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == "float32":
        bar = FA_TOL + FA_TOL * want.abs()
    elif semantics == "chunked":
        bar = bf16_step(torch.maximum(got.abs(), want.abs())) + 2.0 ** -8 * wam
    else:
        bar = bf16_step(torch.maximum(got.abs(), want.abs())) + 1e-6
    if not bool(torch.isfinite(got).all()) or not bool((err <= bar).all()):
        raise AssertionError(f"flash_attention {what} ({semantics}): max "
                             f"|err| {float(err.max())}")
    return float(err.max())


def flash_bound(B, Sq, Skv, H, K, hd, causal, dtype,
                semantics) -> tuple[float, float, float]:
    """(ms at the products' peak, ms at the HBM rate, ms of the
    exponentials at the special-function rate) of one call.  Per (query,
    visible key) pair: 2 B H hd FLOPs in each product and one exp.  bf16
    operands run the products on the tensor cores (989 TFLOP/s): two for
    the chunked function, four for the Pallas one (p . v as p_hi . v +
    p_mid . v + p_lo . v); fp32 operands run both at the fp32 rate.  q,
    k, v read once and the output written once."""
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    product = 2.0 * B * H * hd * pairs
    if dtype == torch.bfloat16:
        n = 2 if semantics == "chunked" else 4
        op_s = n * product / BF16_FLOPS
    else:
        op_s = 2 * product / FP32_FLOPS
    moved = (torch.finfo(dtype).bits // 8) * (2 * B * Sq * H * hd
                                              + 2 * B * Skv * K * hd)
    return (op_s * 1e3, moved / HBM_BYTES_S * 1e3,
            B * H * pairs / EXP_RATE * 1e3)


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spills and static shared memory of each kernel instance
    in a build log (``nvcc -Xptxas -v``), by mangled name."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return out


def flash_instance(report, dtype, hd, semantics) -> dict:
    """The ptxas numbers and the dynamic shared memory of the kernel
    instance a call runs: ``flash_tc_fwd<hd, chunked>`` for bf16 (two q
    tiles and two stages of k and v), ``flash_fwd<ceil(hd/16), chunked>``
    for fp32."""
    chunked = int(semantics == "chunked")
    if dtype == torch.bfloat16:
        key, smem = f"flash_tc_fwdILi{hd}ELb{chunked}E", 6 * 64 * hd * 2
    else:
        dc = next(d for d in (1, 2, 4, 8) if hd <= 16 * d)
        key = f"flash_fwdILi{dc}ELb{chunked}E"
        smem = 4 * ((64 + 64) * (hd | 1) + 64 * 16 * dc + 64 * (64 + 16))
    found = [v for k, v in report.items() if key in k]
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} instances match "
                             f"{key}")
    return {**found[0], "dynamic_smem": smem}


def weighted_abs_mean(fak, q, k, v, scale, causal) -> torch.Tensor:
    """sum_j p_j |v_j| / l in fp32, p the plain (Pallas) softmax."""
    return fak.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                     scale=scale, causal=causal)


def plain_attention(fak, semantics, q, k, v, scale, causal, kv_chunk=512):
    """The plain version of ``semantics``: the chunked function at
    ``kv_chunk`` x ``kv_chunk`` chunks (the reference's 512 unless given),
    or the Pallas function."""
    if semantics == "chunked":
        return fak.chunked_attention_plain(q, k, v, scale=scale,
                                           causal=causal, q_chunk=kv_chunk,
                                           kv_chunk=kv_chunk)
    return fak.flash_attention_plain(q, k, v, scale=scale, causal=causal)


def max_weighted_term(q, k, v, scale, causal, block=64) -> torch.Tensor:
    """max_j p_j |v_j| / l of each output in fp32, p the plain softmax;
    ``block`` queries at a time."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kf = k.float()
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    keys = torch.arange(Skv, device=q.device)[None, :]
    out = torch.empty((B, Sq, H, hd), device=q.device)
    for i0 in range(0, Sq, block):
        qb = q[:, i0:i0 + block].float()
        n = qb.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs",
                         qb.reshape(B, n, K, H // K, hd), kf) * scale
        if causal:
            rows = i0 + torch.arange(n, device=q.device)[:, None]
            s = s.masked_fill(keys > rows, -1e30)
        p = torch.softmax(s, dim=-1)                   # (B, K, G, n, Skv)
        t = (p[..., None] * va).amax(dim=-2)           # (B, K, G, n, hd)
        out[:, i0:i0 + n] = t.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd)
    return out


def check_chunked_tile(fak, got, q, k, v, scale, causal, what):
    """Hold the bf16 kernel's chunked function against the plain chunked
    function at the kernel's own 64-key tiles; raises unless every
    |got - want| <= one bf16 step at max(|got|, |want|) + 1e-6 + 2^-7
    max_j p_j |v_j| / l, returns (max |err|, the plain output).

    With the same tiles both sides round each p~_j against the same
    running max; only their fp32 scores differ (q . k summed in other
    orders), in the last bit.  A p~_j at a bf16 rounding boundary may then
    round one bf16 step (at most 2^-7 p~_j) apart, which moves the output
    by at most 2^-7 p_j |v_j| / l, and each side rounds the output once.
    The Pallas function, whose p is not rounded, lies up to 2^-8 p_j |v_j|
    / l away at every key, not at a few, and fails this bar on short rows
    (tests/test_torch_chunked_attention.py shows it on the CPU);
    ``check_functions`` tells the two apart at every shape."""
    want = plain_attention(fak, "chunked", q, k, v, scale, causal,
                           kv_chunk=64)
    g, w = got.float(), want.float()
    bar = (bf16_step(torch.maximum(g.abs(), w.abs())) + 1e-6
           + 2.0 ** -7 * max_weighted_term(q, k, v, scale, causal))
    err = (g - w).abs()
    if not bool((err <= bar).all()):
        raise AssertionError(f"flash_attention {what} (chunked, 64-key "
                             f"tiles): max |err| {float(err.max())}, "
                             f"{int((err > bar).sum())} outputs past the bar")
    return float(err.max()), want


def check_functions(got, want, what) -> dict:
    """Each bf16 kernel function nearer its own plain version than the
    other function's: the mean |kernel - plain| of ``got[sem]`` against
    ``want[sem]`` at most a quarter of that against the other function's
    plain version, for both functions; raises otherwise, returns the four
    means.  Rounding p to bf16 moves an output by about one step as often
    as not, while the same function on both sides differs only where an
    fp32 last bit moves a rounding: so a kernel that computed the other
    function, or a semantics flag wired backwards, fails."""
    mean = {f"{a} vs plain {b}": float((got[a].float() - want[b].float()
                                        ).abs().mean())
            for a in ("chunked", "pallas") for b in ("chunked", "pallas")}
    for a, b in (("chunked", "pallas"), ("pallas", "chunked")):
        if not 4 * mean[f"{a} vs plain {a}"] <= mean[f"{a} vs plain {b}"]:
            raise AssertionError(f"flash_attention {what}: the {a} kernel "
                                 f"is not nearer its own function: {mean}")
    return mean


def device_ms(fn, name: str) -> float:
    """Device time per call of the kernel ``name`` in ``fn`` (profiler; a
    second profile if the first one reports no such kernel)."""
    for _ in range(2):
        top = profile_device(fn, reps=5)["top"]
        found = [t["ms"] for t in top if f"::{name}<" in t["kernel"]]
        if len(found) == 1:
            return found[0]
    raise AssertionError(f"the profile of {name} shows {top}")


def flash_kernel_phase(fak, ops, gen, report) -> tuple[float, list[dict]]:
    """The flash kernels against their plain versions at FLASH_CASES, each
    row in both of the reference's functions (and, on strided views,
    through the model's wrapper ``ops.flash_attention``), timed (CUDA
    events, and the device time under the profiler) beside the plain
    version, ``scaled_dot_product_attention`` on (B, H, S, hd) transposes
    made outside the timed region, and the bound; bf16 rows also go
    through ``check_chunked_tile`` and ``check_functions``.  Returns (max
    |err|, rows).  Launches here are not counted."""
    import torch.nn.functional as F
    worst, rows = 0.0, []
    for B, S, H, K, hd, causal, dt, what in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda"
                        ).to(dtype)
        k = torch.randn((B, S, K, hd), generator=gen, device="cuda"
                        ).to(dtype)
        v = torch.randn((B, S, K, hd), generator=gen, device="cuda"
                        ).to(dtype)
        scale = hd ** -0.5
        wam = (weighted_abs_mean(fak, q, k, v, scale, causal)
               if dtype == torch.bfloat16 else None)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True),
            iters=10)
        name = "flash_tc_fwd" if dtype == torch.bfloat16 else "flash_fwd"
        outs, plains = {}, {}
        for sem in ("chunked", "pallas"):
            def run():
                return fak.flash_attention_kernel(q, k, v, scale=scale,
                                                  causal=causal,
                                                  semantics=sem)
            got = outs[sem] = run()
            want = plain_attention(fak, sem, q, k, v, scale, causal)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (B, S, H, hd):
                raise AssertionError(f"flash_attention {what}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            err = check_flash(got, want, dt, what, sem, wam)
            worst = max(worst, err)
            checks = {}
            if dtype == torch.bfloat16 and sem == "chunked":
                over = ((got.float() - want.float()).abs()
                        - bf16_step(torch.maximum(got.float().abs(),
                                                  want.float().abs())))
                checks["excess over one step / wam, 512-key plain"] = float(
                    (over / wam).max())
                tile_err, plains["chunked"] = check_chunked_tile(
                    fak, got, q, k, v, scale, causal, what)
                checks["max_abs_err, 64-key plain"] = tile_err
                worst = max(worst, tile_err)
            elif dtype == torch.bfloat16:
                plains["pallas"] = want
            op_ms, byte_ms, exp_ms = flash_bound(B, S, S, H, K, hd, causal,
                                                 dtype, sem)
            rows.append({
                "kernel": "flash_attention", "B": B, "S": S, "H": H,
                "K": K, "hd": hd, "causal": causal, "dtype": dt,
                "case": what, "semantics": sem, "route": fak.route(dtype),
                "max_abs_err": err,
                "ms": cuda_ms(run, iters=10),
                "device_ms": device_ms(run, name),
                "plain_ms": cuda_ms(lambda: plain_attention(
                    fak, sem, q, k, v, scale, causal), iters=5),
                "library_ms": library_ms,
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "exp_bound_ms": exp_ms,
                **checks,
                **flash_instance(report, dtype, hd, sem)})
            del got, want
        if dtype == torch.bfloat16:
            means = check_functions(outs, plains, what)
            for r in rows[-2:]:
                r["mean |err| by function"] = means
        del q, k, v, qt, kt, vt, wam, outs, plains
    # strided operands through the model's wrapper: q, k, v as (B, S,
    # heads, hd) views of (B, heads, S, hd) buffers.  fp32 goes to its
    # kernel as it is, read through the strides; bf16 views with 16-byte
    # aligned rows go uncopied, a view whose rows are not 16-byte aligned
    # is copied contiguous and counted on operand_copies.
    views = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        qb = torch.randn((2, 14, 300, 64), generator=gen, device="cuda")
        kb = torch.randn((2, 2, 300, 64), generator=gen, device="cuda")
        vb = torch.randn((2, 2, 300, 64), generator=gen, device="cuda")
        views[dt] = [t.to(dtype).transpose(1, 2) for t in (qb, kb, vb)]
    wide = torch.randn((2, 300, 2, 68), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    views["bfloat16, k heads 136 bytes apart"] = [
        views["bfloat16"][0], wide[..., :64], views["bfloat16"][2]]
    for what, (q, k, v) in views.items():
        dt = "float32" if q.dtype == torch.float32 else "bfloat16"
        for sem in ("chunked", "pallas"):
            before = ops.flash_attention.launches
            copies = fak.flash_attention_kernel.operand_copies
            got = ops.flash_attention(q, k, v, scale=0.125, semantics=sem)
            if ops.flash_attention.launches != before + 1:
                raise AssertionError("ops.flash_attention did not launch "
                                     "the kernel on strided CUDA views")
            copied = fak.flash_attention_kernel.operand_copies - copies
            if copied != (1 if "136 bytes" in what else 0):
                raise AssertionError(f"strided views ({what}): {copied} "
                                     f"operands copied")
            want = plain_attention(fak, sem, q.contiguous(), k.contiguous(),
                                   v.contiguous(), 0.125, True)
            wam = (weighted_abs_mean(fak, q, k, v, 0.125, True)
                   if dt == "bfloat16" else None)
            worst = max(worst, check_flash(got, want, dt,
                                           f"strided views, {what}", sem,
                                           wam))
    print(f"flash kernel phase: {len(FLASH_CASES)} shapes x 2 functions + "
          f"strided views within their bars (fp32 {FA_TOL} abs + rel; "
          f"bf16 Pallas one bf16 step at the larger |value| + 1e-6; bf16 "
          f"chunked one step + 2^-8 sum p|v|/l, and against 64-key tiles "
          f"one step + 2^-7 max p|v|/l; each bf16 function at most a "
          f"quarter as far from its own plain version on average as from "
          f"the other's); max |err| {worst:.3e}")
    for r in rows:
        print(f"  {r['case']:<28} {r['semantics']:<8} {r['route']:<6} "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), exp co-bound "
              f"{r['exp_bound_ms']:.4f}, plain {r['plain_ms']:.3f}, SDPA "
              f"{r['library_ms']:.4f}; {r['registers']} registers, "
              f"{r['spill_stores']}/{r['spill_loads']} B spilled, "
              f"{r['dynamic_smem']} B dynamic shared memory")
        if "max_abs_err, 64-key plain" in r:
            print(f"    chunked: max |err| against 64-key tiles "
                  f"{r['max_abs_err, 64-key plain']:.3e}; largest excess "
                  f"over one step against 512-key chunks "
                  f"{r['excess over one step / wam, 512-key plain']:.3e} "
                  f"of sum p|v|/l (bar 2^-8); mean |err| by function "
                  + json.dumps(r["mean |err| by function"]))
    return worst, rows


def zero_flash_counts(ops) -> None:
    ops.flash_attention.launches = 0
    for key in fak_routes():
        fak_routes()[key] = 0


def check_flash_counts(ops, n: int, route: str, what: str) -> None:
    """Raise unless the flash wrapper launched exactly ``n`` times since
    the counts were set to 0, all on ``route`` in the chunked function."""
    routes = fak_routes()
    want = {key: (n if key == f"{route}/chunked" else 0) for key in routes}
    if ops.flash_attention.launches != n or routes != want:
        raise AssertionError(f"{what} ran flash_attention "
                             f"{ops.flash_attention.launches} times, routes "
                             f"{routes}; expected {want}")


def lm_prefill_path(ops, model, params, route: str,
                    profile: bool = True) -> dict:
    """qwen2-0.5b ``prefill_fn`` at full width on 4 x 2048 tokens drawn
    from SEED, the flash counts set to 0 before and read after: 24
    launches (one per layer), all on ``route`` (``wgmma``, the tensor-core
    kernel, for bf16 compute; ``simt`` for float32) in the chunked
    function; logits (4, 2048, 152064) finite, pad columns -1e30.  Times
    the call (CUDA events) and, if ``profile``, profiles one."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}
    zero_flash_counts(ops)
    logits = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    routes = dict(fak_routes())
    check_flash_counts(ops, cfg.n_layers, route, f"prefill ({route})")
    want_shape = (PREFILL_BATCH, PREFILL_LEN, cfg.padded_vocab)
    if logits.shape != want_shape or logits.dtype != torch.float32:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}, expected {want_shape}")
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("prefill logits not finite")
    if not bool((logits[..., cfg.vocab_size:] == -1e30).all()):
        raise AssertionError("prefill pad columns are not -1e30")
    del logits
    ms = cuda_ms(lambda: model.prefill_fn(params, batch), iters=3,
                 warmup=1)
    out = {"compute": cfg.compute_dtype,
           "flash_attention launches": launches,
           "flash_attention routes": routes,
           "prefill ms": ms,
           "prefill tokens/s": PREFILL_BATCH * PREFILL_LEN / ms * 1e3}
    pad = cfg.padded_vocab - cfg.vocab_size
    print(f"prefill path ({cfg.compute_dtype} compute): {LM_ARCH} at full "
          f"width, {PREFILL_BATCH} x {PREFILL_LEN} tokens: {launches} "
          f"flash_attention launches (one per layer, all {route}/chunked: "
          f"the {'tensor' if route == 'wgmma' else 'CUDA'}-core kernel in "
          f"chunked_attention's function), logits {want_shape} finite, "
          f"{pad} pad columns -1e30; {ms:.3f} ms per call, "
          f"{out['prefill tokens/s']:.0f} tokens/s")
    if profile:
        out["profile"] = profile_device(
            lambda: model.prefill_fn(params, batch), reps=1)
        print("prefill profile (profiler on): "
              + json.dumps(out["profile"]))
    return out


def fak_routes() -> dict[str, int]:
    """The flash kernels' launch counts by route and function."""
    from repro_torch.kernels import flash_attention as fak
    return fak.flash_attention_kernel.routes


def decode_against_prefill(ops, model, params, BatchedServer,
                           compute: str) -> dict:
    """``BatchedServer`` serves the CLI's prompts (39 steps, 128 tokens),
    recording each step's logits; then ``prefill_fn`` on every slot's
    prompt + generated tokens.  The decode logits at each of the 39
    positions must equal the prefill logits within LOGIT_BAR[compute], and
    each generated token the prefill argmax, except where the prefill's
    top-2 gap lies within the bar (counted).  ``compute`` float32 runs a
    float32 cache.  Returns the numbers, with decode times."""
    cfg = model.cfg
    dtype = getattr(torch, compute)
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(SERVE_BATCH)]      # launch/serve.py's prompts

    def serve():
        server = BatchedServer(model, params, batch=SERVE_BATCH,
                               max_len=SERVE_MAX_LEN, cache_dtype=dtype)
        rec = []

        def recording(p, cache, batch):
            logits, cache = model.decode_fn(p, cache, batch)
            rec.append(logits[:, -1].clone())
            return logits, cache

        server.decode = recording
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = server.generate(prompts, SERVE_NEW)
        end.record()
        end.synchronize()
        return server, outs, rec, start.elapsed_time(end)

    serve()                                   # warm-up
    zero_flash_counts(ops)
    server, outs, rec, total_ms = serve()
    serve_launches = ops.flash_attention.launches   # decode only: 0
    steps, toks = server.stats.steps, server.stats.tokens_out
    if (steps, toks) != (8 + SERVE_NEW - 1, SERVE_BATCH * SERVE_NEW):
        raise AssertionError(f"server: {steps} steps, {toks} tokens; "
                             f"expected 39 and 128")
    seqs = torch.tensor([p + o for p, o in zip(prompts, outs)],
                        dtype=torch.int32, device="cuda")
    zero_flash_counts(ops)
    full = model.prefill_fn(params, {"tokens": seqs})
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    route = "wgmma" if compute == "bfloat16" else "simt"
    check_flash_counts(ops, cfg.n_layers, route, "the check's prefill")
    dec = torch.stack(rec, dim=1)                        # (B, 39, V)
    pre = full[:, :steps]
    err = (dec - pre).abs()[..., :cfg.vocab_size]
    bar = LOGIT_BAR[compute]
    if not bool(torch.isfinite(dec[..., :cfg.vocab_size]).all()) or \
            float(err.max()) > bar:
        raise AssertionError(f"decode vs prefill ({compute}): max |Δ| "
                             f"{float(err.max())} > {bar}")
    top2 = torch.topk(pre[:, 7:], 2, dim=-1).values      # generating steps
    gap = top2[..., 0] - top2[..., 1]
    got = torch.tensor(outs, device="cuda")
    off = got != pre[:, 7:].argmax(-1)
    if bool((off & (gap > bar)).any()):
        raise AssertionError(f"decode ({compute}): a generated token is "
                             f"not the prefill argmax away from a near-tie")
    # one more decode step of the served batch under the profiler: where a
    # step's time goes (it appends to the served cache, which has room)
    step_batch = {"tokens": seqs[:, -1:], "length": steps}
    prof = profile_device(lambda: model.decode_fn(params, server.cache,
                                                  step_batch))
    out = {"compute": compute, "max |decode - prefill| logit":
           float(err.max()), "bar": bar,
           "tokens excused as near-ties": int(off.sum()),
           "positions with a top-2 gap within the bar": int(
               (gap <= bar).sum()),
           "flash_attention launches in the check's prefill": launches,
           "flash_attention route in the check's prefill":
               f"{route}/chunked",
           "flash_attention launches in BatchedServer.generate":
               serve_launches,
           "steps": steps, "tokens_out": toks,
           "decode ms per step": total_ms / steps,
           "decode tokens/s": toks / total_ms * 1e3,
           "decode step profile": prof}
    print(f"decode vs prefill ({compute} compute and cache): {steps} "
          f"steps, {toks} tokens; max |decode - prefill| logit "
          f"{out['max |decode - prefill| logit']:.3e} (bar {bar}); "
          f"{out['tokens excused as near-ties']} generated tokens differ "
          f"from the prefill argmax, all at near-ties; "
          f"{out['decode ms per step']:.3f} ms per step, "
          f"{out['decode tokens/s']:.1f} tokens/s; {serve_launches} "
          f"flash_attention launches while serving (decode attention is "
          f"plain); one step under the "
          f"profiler: {prof['span_ms']:.3f} ms span, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['device_idle_share']:.3f}")
    return out


def lm_path(ops) -> dict:
    """The LM serving path (module docstring, steps 11-12)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import BatchedServer
    model = build_model(get_config(LM_ARCH), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    model32 = build_model(get_config(LM_ARCH, compute_dtype="float32"),
                          "cuda")
    out = {"prefill": lm_prefill_path(ops, model, params, "wgmma"),
           "prefill fp32": lm_prefill_path(ops, model32, params, "simt",
                                           profile=False)}
    out["decode bf16"] = decode_against_prefill(ops, model, params,
                                                BatchedServer, "bfloat16")
    out["decode fp32"] = decode_against_prefill(ops, model32, params,
                                                BatchedServer, "float32")
    out["flash_attention launches serving"] = sum(
        out[d]["flash_attention launches in BatchedServer.generate"]
        for d in ("decode bf16", "decode fp32"))
    return out


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


def replay_kernels(fn) -> dict[str, int]:
    """The port's kernels, by name and launch count, in one profiled call
    of ``fn`` (after one unprofiled call, so a compiled ``fn`` replays)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    pattern = re.compile(r"::(" + "|".join(KERNELS) + r")[(<]")
    found: dict[str, int] = {}
    for e in prof.key_averages():
        m = pattern.search(e.key)
        if m and str(e.device_type).endswith("CUDA"):
            found[m.group(1)] = found.get(m.group(1), 0) + e.count
    return found


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs.paper_apps import PAPER_SPEC
    from repro_torch.core import hw_model as hw
    from repro_torch.core.crossbar import mlp_forward, paper_backprop_step
    from repro_torch.kernels import _build, crossbar as xbk, kmeans as kmk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops
    from repro_torch.launch.chipsim import build_chip
    from repro_torch.sim import chip as chip_mod, compiled as csim

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

    report = ptxas_report("\n".join(lib.log for lib in libs))
    print("ptxas, dw and pulse instances [registers, spill bytes, dynamic "
          "shared memory]: " + json.dumps(outer_product_ptxas(report)))

    phase_s = {"build": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    max_err, rows = kernel_phase(xbk, ops, gen)
    train_err, train_rows = train_kernel_phase(xbk, ops, gen)
    pins = outer_product_phase(xbk, gen)
    sweep = tile_sweep(xbk, gen)
    print(f"dw and pulse device ms by tile [{card}]: " + json.dumps(sweep))
    fused_err, fused_rows = fused_kernel_phase(xbk, ops, gen)
    phase_s["kernel phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    km_flips, km_rows = kmeans_kernel_phase(kmk, gen)
    phase_s["kmeans kernel phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fa_err, fa_rows = flash_kernel_phase(fak, ops, gen, report)
    phase_s["flash kernel phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- eager recognition path: the counts start at 0 and are read after
    mnist = build_chip("mnist_class", seed=SEED, device="cuda",
                       compiled=False)
    isolet = build_chip("isolet_class", seed=SEED, device="cuda",
                        compiled=False)
    x16 = uniform((16, 784), -0.5, 0.5, gen)
    x4096 = uniform((4096, 784), -0.5, 0.5, gen)
    x_iso = uniform((256, 617), -0.5, 0.5, gen)
    ops.crossbar_fwd_stacked.launches = 0
    ops.crossbar_fwd.launches = 0
    out16, _ = run_wave(mnist, x16, ops, 5)
    out4096, stream = run_wave(mnist, x4096, ops, 5)
    out_iso, stream_iso = run_wave(isolet, x_iso, ops, 9)
    launches = ops.crossbar_fwd_stacked.launches + ops.crossbar_fwd.launches
    print(f"eager recognition path: {launches} kernel launches (mnist 5 + "
          f"5, isolet 9)")

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
    phase_s["eager recognition path"] = time.perf_counter() - t0

    # -- compiled recognition path
    t0 = time.perf_counter()
    rec_chips, rec_launches = compiled_recognition(
        ops, csim, build_chip, mlp_forward, hw,
        {"mnist_class": mnist, "isolet_class": isolet},
        [("mnist_class", x16, out16), ("mnist_class", x4096, out4096),
         ("isolet_class", x_iso, out_iso)])
    phase_s["compiled recognition path"] = time.perf_counter() - t0

    # -- training paths and crossbar_apply(use_kernel=True) path
    t0 = time.perf_counter()
    train_launches = train_path(ops, chip_mod, build_chip, PAPER_SPEC,
                                paper_backprop_step, hw, gen)
    phase_s["eager training path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctrain_launches = compiled_train_path(ops, csim, chip_mod, build_chip,
                                          PAPER_SPEC, hw, gen)
    phase_s["compiled training path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apply_launches, apply_err = apply_path(ops, mnist.layers(), PAPER_SPEC,
                                           gen)
    phase_s["crossbar_apply path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apps = paper_apps_path(ops)
    phase_s["paper-apps path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = lm_path(ops)
    phase_s["LM serving path"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- wave and step times (device events, after warm-up), compiled
    # beside eager in this one run
    t4096 = uniform((4096, 10), -0.5, 0.5, gen)
    t_iso = uniform((256, 26), -0.5, 0.5, gen)
    times = {}
    for mode, chips in (("eager", {"mnist_class": mnist,
                                   "isolet_class": isolet}),
                        ("compiled", rec_chips)):
        times[f"{mode} wave mnist_class x4096 ms"] = cuda_ms(
            lambda: chips["mnist_class"].infer(x4096, count=False), iters=10)
        times[f"{mode} wave isolet_class x256 ms"] = cuda_ms(
            lambda: chips["isolet_class"].infer(x_iso, count=False),
            iters=10)
    steppers = {
        mode: {app: build_chip(app, seed=SEED, device="cuda",
                               compiled=mode == "compiled")
               for app in ("mnist_class", "isolet_class")}
        for mode in ("eager", "compiled")}
    for mode, st in steppers.items():
        times[f"{mode} step mnist_class x4096 ms"] = cuda_ms(
            lambda: st["mnist_class"].train_step(x4096, t4096, lr=LR),
            iters=5, warmup=2)
        times[f"{mode} step isolet_class x256 ms"] = cuda_ms(
            lambda: st["isolet_class"].train_step(x_iso, t_iso, lr=LR),
            iters=5, warmup=2)
    t1 = time.perf_counter()
    mnist.infer_stream(x16)
    torch.cuda.synchronize()
    times["eager infer_stream mnist_class x16 host wall ms"] = \
        (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    rec_chips["mnist_class"].infer_stream(x16)
    torch.cuda.synchronize()
    times["compiled infer_stream mnist_class x16 host wall ms"] = \
        (time.perf_counter() - t1) * 1e3
    print(f"times [{card}]: " + json.dumps(times))
    print(f"samples/s: mnist wave x4096 eager "
          f"{4096 / times['eager wave mnist_class x4096 ms'] * 1e3:.0f}, "
          f"compiled "
          f"{4096 / times['compiled wave mnist_class x4096 ms'] * 1e3:.0f};"
          f" mnist step x4096 eager "
          f"{4096 / times['eager step mnist_class x4096 ms'] * 1e3:.0f}, "
          f"compiled "
          f"{4096 / times['compiled step mnist_class x4096 ms'] * 1e3:.0f}")
    print("kernel shapes (M=4096): "
          + json.dumps(rows + train_rows + fused_rows))
    print(f"kmeans_assign shapes [{card}]: " + json.dumps(km_rows))
    print(f"flash_attention shapes [{card}]: " + json.dumps(fa_rows))
    print(f"LM serving path [{card}]: " + json.dumps(
        {k: v for k, v in lm.items() if k != "prefill"}))
    cstep = steppers["compiled"]["mnist_class"]
    kernels = replay_kernels(
        lambda: cstep.train_step(x4096, t4096, lr=LR))
    if kernels != {"crossbar_fwd": 4, "crossbar_train": 4}:
        raise AssertionError(f"a profiled replay of the compiled mnist step "
                             f"ran the port's kernels {kernels}, expected "
                             f"4 crossbar_fwd + 4 crossbar_train")
    print("profiled replay of one compiled mnist_class step: port kernels "
          + json.dumps(kernels))
    for what, fn in (
            ("eager mnist_class 4096-sample wave",
             lambda: mnist.infer(x4096, count=False)),
            ("compiled mnist_class 4096-sample wave",
             lambda: rec_chips["mnist_class"].infer(x4096, count=False)),
            ("eager mnist_class train_step at batch 4096",
             lambda: steppers["eager"]["mnist_class"].train_step(
                 x4096, t4096, lr=LR)),
            ("compiled mnist_class train_step at batch 4096",
             lambda: cstep.train_step(x4096, t4096, lr=LR))):
        print(f"profile, {what} (profiler on): "
              + json.dumps(profile_device(fn)))

    fwd_rows = {(r["T"], r["K"], r["N"]): r for r in rows
                if r["app"] == "mnist_class"}
    by_kernel = {
        "crossbar_fwd": ([fwd_rows[s] for s in WAVE_SHAPES["mnist_class"]],
                         "the 5 launches of one eager mnist_class wave at "
                         "M=4096"),
        "crossbar_bwd": (step_rows(train_rows, "crossbar_bwd"),
                         "the 4 launches of one eager mnist_class training "
                         "step at M=4096"),
        "pulse_update": (step_rows(train_rows, "pulse_update"),
                         "the 4 launches of one eager mnist_class training "
                         "step at M=4096"),
        "crossbar_dw": ([r for r in train_rows if r.get("codes")],
                        "the 4 launches of crossbar_apply(use_kernel=True)'s "
                        "backward through mnist's layers at M=4096, int8 "
                        "codes"),
        "crossbar_train": (step_rows(fused_rows, "crossbar_train"),
                           "the 4 launches of one compiled mnist_class "
                           "training step at M=4096"),
    }
    counted = {
        "crossbar_fwd": launches + train_launches["crossbar_fwd_stacked"]
        + apply_launches["crossbar_fwd"]
        + rec_launches["crossbar_fwd_stacked"]
        + ctrain_launches["crossbar_fwd_stacked"],
        "crossbar_bwd": train_launches["crossbar_bwd_stacked"]
        + apply_launches["crossbar_bwd"],
        "crossbar_dw": apply_launches["crossbar_dw"],
        "pulse_update": train_launches["pulse_update_stacked"],
        "crossbar_train": ctrain_launches["crossbar_train_stacked"],
    }
    errs = {"crossbar_fwd": max_err, **train_err,
            "crossbar_train": fused_err}
    errs["crossbar_bwd"] = max(errs["crossbar_bwd"], apply_err)
    errs["crossbar_dw"] = max(errs["crossbar_dw"], apply_err)
    replaces = {"crossbar_fwd": 84, "crossbar_bwd": 145, "crossbar_dw": 207,
                "pulse_update": 403, "crossbar_train": 308}
    entries = []
    for name, (timed, what) in by_kernel.items():
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
        if name in ("crossbar_dw", "pulse_update"):   # device times too
            entries[-1]["timed"] += (
                "; *_ms_device: the same launches by device time (a CUDA "
                "graph of 20 calls replayed), the kernel's and torch.bmm's; "
                "tiles: the OUTER_PRODUCT_TILES index each launch took; "
                "bit_pins: shapes of pins (a) and (b), (kernel, shape, "
                "tile) triples equal to the picked tile")
            entries[-1].update(
                ms_device=sum(r["ms_device"] for r in timed),
                library_ms_device=sum(r["library_ms_device"] for r in timed),
                ms_device_per_launch=[r["ms_device"] for r in timed],
                tiles=[r["tile"] for r in timed], bit_pins=pins)
    next(e for e in entries if e["name"] == "crossbar_dw")[
        "fp32_mnist_step_ms_device"] = [
            r["ms_device"] for r in step_rows(train_rows, "crossbar_dw")]
    km = km_rows[0]     # the clustering path's own shape
    entries.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans.py:26",
        "launches": apps["kmeans_assign launches"],
        "max_abs_err": km_flips + apps["near_tie_flips"],
        "ms": km["ms"], "plain_ms": km["plain_ms"],
        "bound_ms": km["bound_ms"], "bound_by": km["bound_by"],
        "library_ms": km["library_ms"],
        "timed": "one launch at the clustering path's shape (n=2048, "
                 "d=20, k=10); max_abs_err counts assignments that "
                 "differ from plain (near-ties only)"})
    def fa_row(dt, sem):    # the prefill path's own shape
        return next(r for r in fa_rows if r["case"].startswith(
            "qwen2-0.5b prefill") and r["dtype"] == dt
            and r["semantics"] == sem)
    for name, dt, source, launches, what in (
            ("flash_attention", "bfloat16", "flash_attention_tc.cu",
             lm["prefill"]["flash_attention launches"],
             "launches: the bf16 prefill path, one prefill_fn call (24, "
             "one per layer, all wgmma/chunked)"),
            ("flash_attention_simt", "float32", "flash_attention.cu",
             lm["prefill fp32"]["flash_attention launches"],
             "launches: the float32 prefill path, one prefill_fn call (24, "
             "one per layer, all simt/chunked)")):
        fa = fa_row(dt, "chunked")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "launches": launches,
            "launches_serving_path": lm["flash_attention launches serving"],
            "max_abs_err": max(max(r["max_abs_err"],
                                   r.get("max_abs_err, 64-key plain", 0.0))
                               for r in fa_rows if r["dtype"] == dt),
            "ms": fa["ms"], "plain_ms": fa["plain_ms"],
            "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
            "library_ms": fa["library_ms"],
            "pallas_ms": fa_row(dt, "pallas")["ms"],
            "timed": f"one launch at qwen2-0.5b's prefill shape (B=4, "
                     f"S=2048, H=14, K=2, hd=64, causal, {dt}) in "
                     f"chunked_attention's function (pallas_ms: the Pallas "
                     f"function); {what}; launches_serving_path: "
                     f"BatchedServer.generate, bf16 and fp32 (decode only, "
                     f"plain attention); bound: both products at the "
                     f"{'bf16 tensor-core' if dt == 'bfloat16' else 'fp32'}"
                     f" rate; library: scaled_dot_product_attention in "
                     f"{dt}"})
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
