"""§Perf hillclimbing runner (port of ``repro/launch/perf.py``).

Runs named variants of the selected cells through the dry run and prints
before/after roofline deltas.  Each variant encodes one hypothesis; the
cells and variants are the reference's, arch for arch and variant for
variant, on the port's traces and H100 figures.

  PYTHONPATH=src python -m repro_torch.launch.perf [--only CELL]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.sweep import run_cell

OUT = "experiments/perf-cuda"

# (cell-name, arch, shape, mesh, variants)
# variant = (tag, mode, overrides, rules)
CELLS = [
    # H-A: most collective-bound cell
    ("A-mistral-train", "mistral-nemo-12b", "train_4k", "single", [
        ("base", "standard", [], []),
        ("noactshard", "standard", [], ["act_embed="]),
        ("skipblocks", "standard", ["skip_masked_blocks=true"], []),
        ("rematdots", "standard", ["remat=dots"], []),
        ("combo", "standard",
         ["skip_masked_blocks=true", "remat=dots"], ["act_embed="]),
    ]),
    # H-B: biggest model / most representative compute cell
    ("B-qwen110b-train", "qwen1.5-110b", "train_4k", "single", [
        ("base", "standard", [], []),
        ("skipblocks", "standard", ["skip_masked_blocks=true"], []),
        ("rematdots", "standard", ["remat=dots", "grad_accum=16"], []),
        ("noactshard", "standard", ["grad_accum=16"], ["act_embed="]),
        ("combo", "standard",
         ["skip_masked_blocks=true", "remat=dots", "grad_accum=16"], []),
        # round 2: stack the confirmed wins, scale accum for memory
        ("r2-noact-dots", "standard",
         ["remat=dots", "grad_accum=32"], ["act_embed="]),
        ("r2-noact-dots-skip", "standard",
         ["remat=dots", "grad_accum=32", "skip_masked_blocks=true"],
         ["act_embed="]),
    ]),
    # H-C: memory-bound decode + the paper's quantized-transport fix
    ("C-qwen110b-decode", "qwen1.5-110b", "decode_32k", "single", [
        ("base", "standard", [], []),
        ("int8kv", "standard", ["kv_cache_dtype=int8"], []),
        # round 2: decode collectives are FSDP weight gathers; replicating
        # the activation embed dim lets the partitioner contract against
        # local weight shards + psum small outputs instead of gathering
        ("r2-int8-noact", "standard", ["kv_cache_dtype=int8"],
         ["act_embed="]),
    ]),
    # H-D: the paper's technique itself (crossbar execution mode)
    ("D-yi6b-xbar", "yi-6b", "train_4k", "single", [
        ("base", "standard", [], []),
        ("crossbar", "crossbar", [], []),
        ("crossbar-skip", "crossbar", ["skip_masked_blocks=true"], []),
        # round 2: (w, common-mode) reparametrization — common mode has
        # zero gradient, so collective traffic returns to ~1x
        ("r2-xbar-wire", "crossbar", ["xbar_paired=false"], []),
    ]),
]


def load(tag_path):
    with open(tag_path) as f:
        return json.load(f)


def fmt(r):
    rf, m = r["roofline"], r["memory"]
    return (f"mem={m['per_device_bytes']/2**30:6.2f}GiB "
            f"comp={rf['t_compute']*1e3:9.2f}ms "
            f"memT={rf['t_memory']*1e3:9.2f}ms "
            f"coll={rf['t_collective']*1e3:9.2f}ms "
            f"bound={rf['t_bound']*1e3:9.2f}ms({rf['bottleneck'][:4]}) "
            f"mfu={rf['mfu_bound']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)

    for cell, arch, shape, mesh, variants in CELLS:
        if args.only and args.only != cell:
            continue
        print(f"\n=== {cell}: {arch} x {shape} x {mesh} ===")
        base = None
        for tag, mode, overrides, rules in variants:
            name = f"{arch}__{shape}__{mesh}__{mode}__{cell}-{tag}.json"
            path = os.path.join(OUT, name)
            if not os.path.exists(path):
                ok, dt, log = run_cell(
                    arch, shape, mesh, mode=mode, out=OUT,
                    tag=f"{cell}-{tag}", overrides=overrides, rules=rules)
                if not ok:
                    print(f"  {tag:14s} FAILED ({dt:.0f}s)")
                    print(log[-1500:])
                    continue
            r = load(path)
            if "skipped" in r:
                print(f"  {tag:14s} SKIP")
                continue
            line = fmt(r)
            if base is None:
                base = r
                print(f"  {tag:14s} {line}")
            else:
                b = base["roofline"]["t_bound"]
                v = r["roofline"]["t_bound"]
                print(f"  {tag:14s} {line}  bound x{v/b:.2f}")


if __name__ == "__main__":
    main()
