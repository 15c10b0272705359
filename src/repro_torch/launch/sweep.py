"""Incremental dry-run sweep (port of ``repro/launch/sweep.py``).

Spawns one ``repro_torch.launch.dryrun`` subprocess per (arch x shape x
mesh) cell and caches results as JSON, so re-runs only execute missing
cells.  Each trace runs on the CPU under ``FakeTensorMode``: no card is
needed.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--mesh single multi] [--force]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, list_archs

OUT = "experiments/dryrun-cuda"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def cell_path(out, arch, shape, mesh, mode="standard", tag=""):
    tag = f"__{tag}" if tag else ""
    return os.path.join(out, f"{arch}__{shape}__{mesh}__{mode}{tag}.json")


def run_cell(arch, shape, mesh, *, mode="standard", out=OUT, tag="",
             overrides=(), rules=(), timeout=3600):
    """Run one cell's dry run in a subprocess from the repository root;
    returns (ok, seconds, the last 4000 characters of its output)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--mode", mode, "--out", out]
    if tag:
        cmd += ["--tag", tag]
    for ov in overrides:
        cmd += ["--override", ov]
    for rv in rules:
        cmd += ["--rules", rv]
    env = dict(os.environ, PYTHONPATH="src")
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    dt = time.time() - t0
    ok = p.returncode == 0
    return ok, dt, (p.stdout + p.stderr)[-4000:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--archs", nargs="+", default=None)
    ap.add_argument("--shapes", nargs="+", default=None)
    ap.add_argument("--mode", default="standard")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = args.archs or list_archs()
    shapes = args.shapes or list(SHAPES)
    os.makedirs(args.out, exist_ok=True)

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh in args.mesh:
                path = cell_path(args.out, arch, shape, mesh, args.mode)
                if os.path.exists(path) and not args.force:
                    print(f"cached  {os.path.basename(path)}")
                    continue
                print(f"running {arch} {shape} {mesh} ...", flush=True)
                ok, dt, log = run_cell(arch, shape, mesh, mode=args.mode,
                                       out=args.out)
                status = "ok" if ok else "FAIL"
                print(f"  {status} in {dt:.0f}s", flush=True)
                if not ok:
                    print(log, flush=True)
                    fail_path = path.replace(".json", ".FAILED.log")
                    with open(fail_path, "w") as f:
                        f.write(log)
                results.append((arch, shape, mesh, ok, dt))

    n_ok = sum(1 for r in results if r[3])
    print(f"\nsweep: {n_ok}/{len(results)} newly-run cells succeeded")


if __name__ == "__main__":
    main()
