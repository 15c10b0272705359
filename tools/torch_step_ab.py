#!/usr/bin/env python3
"""Time the port's training step of several trees in one call on one card,
and hold their outputs against each other bit for bit.

  python3 tools/torch_step_ab.py PARENT . . PARENT

Each argument is the root of a checkout of the repository (for a parent
commit: ``git archive <commit>`` unpacked into a directory ``.gitignore``
lists); each runs in a process of its own, in the order given, so that a
change and its parent alternate on the same card.  For each it builds the
crossbar kernels of that tree, makes mnist_class and isolet_class chips
with seed 0, and prints one JSON line: the eager and the compiled
``train_step`` times (CUDA events over 10 steps after 3 of warm-up; mnist
at batch 4096, isolet at 256), the eager mnist step's device busy time
and idle share under ``torch.profiler``, and the kernel wrappers' times:
``ops.crossbar_bwd_stacked`` on the eager mnist step's four stacks at
M = 4096 and ``ops.kmeans_assign`` at the clustering path's (2048, 20, 10)
by CUDA events (back-to-back calls, the host's time included where it is
the longer) and by device time (a CUDA graph of 20 calls replayed), each
wrapper's host time per call (a host clock over 500 calls at a shape the
card finishes sooner), ``kmeans_assign`` at (65536, 128, 128) and
``ops.crossbar_bwd`` on int8 codes at mnist's four layers (M = 4096,
crossbar_apply's launches) by device time, and the fused kernel on the
same four stacks by device time.  Each tree also computes, on
inputs drawn from seed 1, the mnist_class wave at 4096 samples on a
compiled and on an eager chip and the conductances after one compiled
step at batch 4096 from seed 0; the last line holds every tree's outputs
against the first tree's: equal, up to the sign of a zero (``==``, so
-0.0 equals 0.0, and no NaN).  The card's name and power limit come first.
Needs a CUDA card and the CUDA toolkit; exits 1 if the outputs differ.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile

KERNELS = ["crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
           "crossbar_train", "kmeans_assign"]
# (T, K, N) of the eager mnist_class step's bwd launches, at M = 4096
MNIST_STACKS = [(6, 400, 100), (2, 400, 100), (1, 400, 100), (1, 400, 100)]


def step_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    import torch
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
    """Device time per call of ``fn``: a CUDA graph of ``calls`` calls
    replayed ``reps`` times between two events."""
    import torch
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


def host_us(fn, calls: int = 500) -> float:
    """Host time per call of ``fn`` (the enqueue, without waiting for the
    card), microseconds."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def wrappers(gen) -> dict:
    """The bwd and k-means wrappers' times and the fused kernel's."""
    import torch
    from repro_torch.kernels import crossbar as xbk, ops

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda") * (hi - lo) + lo

    out = {"bwd events ms": 0.0, "bwd device ms": 0.0,
           "fused device ms": 0.0}
    lr = torch.full((1,), 0.01, device="cuda")
    for T, K, N in MNIST_STACKS:
        d = uniform((T, 4096, N), -0.05, 0.05)
        x = uniform((T, 4096, K), -0.5, 0.5)
        gp, gm = uniform((T, K, N), 0.3, 0.7), uniform((T, K, N), 0.3, 0.7)
        out["bwd events ms"] += step_ms(
            lambda: ops.crossbar_bwd_stacked(d, gp, gm), iters=20)
        out["bwd device ms"] += graph_ms(
            lambda: ops.crossbar_bwd_stacked(d, gp, gm))
        out["fused device ms"] += graph_ms(
            lambda: xbk.crossbar_train_kernel(gp, gm, x, d, lr=lr))
    d = uniform((1, 64, 100), -0.05, 0.05)
    gp, gm = uniform((1, 400, 100), 0.3, 0.7), uniform((1, 400, 100), 0.3, 0.7)
    out["bwd host us per call at (1, 64, 400, 100)"] = host_us(
        lambda: ops.crossbar_bwd_stacked(d, gp, gm))
    out["bwd device us at (1, 64, 400, 100)"] = 1e3 * graph_ms(
        lambda: ops.crossbar_bwd_stacked(d, gp, gm))
    scale = torch.tensor(0.05 / 127, device="cuda")
    for K, N in ((784, 300), (300, 200), (200, 100), (100, 10)):
        codes = torch.randint(-127, 128, (4096, N), generator=gen,
                              dtype=torch.int8, device="cuda")
        gp, gm = uniform((K, N), 0.3, 0.7), uniform((K, N), 0.3, 0.7)
        out[f"bwd int8 (4096, {K}, {N}) device ms"] = graph_ms(
            lambda: ops.crossbar_bwd(codes, gp, gm, dy_scale=scale))
    x, c = uniform((2048, 20), -0.5, 0.5), uniform((10, 20), -0.5, 0.5)
    out["kmeans (2048, 20, 10) events ms"] = step_ms(
        lambda: ops.kmeans_assign(x, c), iters=200)
    out["kmeans (2048, 20, 10) device ms"] = graph_ms(
        lambda: ops.kmeans_assign(x, c))
    out["kmeans host us per call at (2048, 20, 10)"] = host_us(
        lambda: ops.kmeans_assign(x, c))
    x, c = uniform((65536, 128), -0.5, 0.5), uniform((128, 128), -0.5, 0.5)
    out["kmeans (65536, 128, 128) device ms"] = graph_ms(
        lambda: ops.kmeans_assign(x, c))
    return out


def busy(fn, reps: int = 3) -> dict:
    """Device busy ms per call and the idle share of the calls' span."""
    import torch
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
    span = start.elapsed_time(end) / reps
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA")) / 1e3 / reps
    return {"span_ms": span, "device_busy_ms": device,
            "device_idle_share": 1.0 - device / span}


def outputs(build_chip) -> dict:
    """The mnist_class wave at 4096 samples, compiled and eager, and the
    conductances after one compiled step at batch 4096 (inputs from seed
    1, chips from seed 0)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((4096, 784), generator=gen, device="cuda") - 0.5
    t = torch.rand((4096, 10), generator=gen, device="cuda") - 0.5
    out = {}
    for mode in ("compiled", "eager"):
        chip = build_chip("mnist_class", seed=0, device="cuda",
                          compiled=mode == "compiled")
        out[f"{mode} wave"] = chip.infer(x, count=False).cpu()
    chip = build_chip("mnist_class", seed=0, device="cuda", compiled=True)
    chip.train_step(x, t, lr=0.1)
    for i, layer in enumerate(chip.layers()):
        for name, g in layer.items():
            out[f"compiled step layer {i} {name}"] = g.cpu()
    return out


def one(root: pathlib.Path, save: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.chipsim import build_chip
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_all(KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # first: a CUDA graph captured after the compiled chips are dropped may
    # meet their graphs' teardown
    timed = wrappers(gen)
    torch.save(outputs(build_chip), save)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device="cuda") - 0.5

    data = {"mnist_class": (uniform((4096, 784)), uniform((4096, 10))),
            "isolet_class": (uniform((256, 617)), uniform((256, 26)))}
    out = {"tree": str(root)}
    for mode in ("eager", "compiled"):
        for app, (x, t) in data.items():
            chip = build_chip(app, seed=0, device="cuda",
                              compiled=mode == "compiled")
            out[f"{mode} step {app} x{x.shape[0]} ms"] = step_ms(
                lambda: chip.train_step(x, t, lr=0.1))
            if (mode, app) == ("eager", "mnist_class"):
                out["eager mnist_class step profile"] = busy(
                    lambda: chip.train_step(x, t, lr=0.1))
    out["wrappers"] = timed
    return out


def compare(saved: list[pathlib.Path], roots: list[str]) -> dict:
    """Every later tree's outputs against the first tree's, by position and
    name: equal up to the sign of a zero; the count of values that differ
    otherwise."""
    import torch
    first = torch.load(saved[0])
    result = {}
    for i, (path, root) in enumerate(zip(saved[1:], roots[1:]), 1):
        other = torch.load(path)
        differ = {k: int((~(other[k] == v)).sum()) for k, v in first.items()}
        result[f"{i} {root}"] = {
            "equal": not any(differ.values()),
            "values differing": {k: n for k, n in differ.items() if n}}
    return {"against": f"0 {roots[0]}", "outputs": sorted(first),
            "trees": result}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(pathlib.Path(argv[1]).resolve(),
                             pathlib.Path(argv[2]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        saved = [pathlib.Path(tmp) / f"{i}.pt" for i in range(len(argv))]
        for root, save in zip(argv, saved):
            proc = subprocess.run([sys.executable, __file__, "--one", root,
                                   str(save)])
            if proc.returncode != 0:
                return proc.returncode
        result = compare(saved, argv)
    print(json.dumps(result), flush=True)
    return 0 if all(r["equal"] for r in result["trees"].values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
