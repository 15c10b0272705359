"""Render the dry run's tables from its JSON cache (port of
``repro/launch/report.py``; the port's records, H100 figures).

  PYTHONPATH=src python -m repro_torch.launch.report [--out experiments/dryrun-cuda]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import HBM_PER_CHIP

HBM_GIB = f"{HBM_PER_CHIP / 2**30:.2f} GiB"


def load(out_dir: str, mode: str = "standard"):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mode", "standard") == mode:
            cells.append(r)
    return cells


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def roofline_table(cells, mesh: str) -> str:
    rows = []
    hdr = (f"| arch | shape | fits (GiB/card of {HBM_GIB}) | t_comp ms | "
           f"t_mem ms | t_coll ms | bottleneck | useful/traced | MFU-bound |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for r in cells:
        if r.get("mesh") != mesh:
            continue
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                        f"SKIP | — | — |")
            continue
        rf, m = r["roofline"], r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{'✓' if m['fits'] else '✗'} {fmt_bytes(m['per_device_bytes'])} | "
            f"{rf['t_compute']*1e3:.2f} | {rf['t_memory']*1e3:.2f} | "
            f"{rf['t_collective']*1e3:.2f} | {rf['bottleneck']} | "
            f"{rf['useful_flops_ratio']:.2f} | {rf['mfu_bound']:.3f} |")
    return "\n".join(rows)


def summary(cells):
    ok = [c for c in cells if "skipped" not in c]
    skips = [c for c in cells if "skipped" in c]
    fits = [c for c in ok if c["memory"]["fits"]]
    bn = {}
    for c in ok:
        bn[c["roofline"]["bottleneck"]] = bn.get(c["roofline"]["bottleneck"], 0) + 1
    return (f"{len(ok)} traced cells ({len(skips)} recorded skips); "
            f"{len(fits)}/{len(ok)} fit in {HBM_GIB}/card; bottlenecks: {bn}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun-cuda")
    ap.add_argument("--mode", default="standard")
    args = ap.parse_args(argv)
    cells = load(args.out, args.mode)
    print("## Summary\n")
    print(summary(cells))
    for mesh in ("single", "multi"):
        print(f"\n## Roofline — {mesh} pod mesh "
              f"({'(2,16,16)=512' if mesh == 'multi' else '(16,16)=256'} "
              f"devices, folded)\n")
        print(roofline_table(cells, mesh))


if __name__ == "__main__":
    main()
