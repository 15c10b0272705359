#!/usr/bin/env python3
"""Time the port's training step of several trees in one call on one card.

  python3 tools/torch_step_ab.py PARENT . . PARENT

Each argument is the root of a checkout of the repository (for a parent
commit: ``git archive <commit>`` unpacked into a directory ``.gitignore``
lists); each runs in a process of its own, in the order given, so that a
change and its parent alternate on the same card.  For each it builds the
crossbar kernels of that tree, makes mnist_class and isolet_class chips
with seed 0, and prints one JSON line: the eager and the compiled
``train_step`` times (CUDA events over 10 steps after 3 of warm-up; mnist
at batch 4096, isolet at 256) and the eager mnist step's device busy time
and idle share under ``torch.profiler``.  The card's name and power limit
come first.  Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

KERNELS = ["crossbar_fwd", "crossbar_bwd", "crossbar_dw", "pulse_update",
           "crossbar_train"]


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


def one(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.chipsim import build_chip
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_all(KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)

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
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
