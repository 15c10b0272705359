"""Chip-farm CLI: serve and train a paper application on N virtual chips.

  PYTHONPATH=src python -m repro_torch.launch.farm --app kdd_anomaly --chips 4
  PYTHONPATH=src python -m repro_torch.launch.farm --app mnist_class \\
      --chips 2 --requests 16 --train-steps 2 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.farm --app kdd_anomaly \\
      --chips 2 --reconcile int8 --json farm.json
  PYTHONPATH=src python -m repro_torch.launch.farm --app mnist_class \\
      --chips 4 --device cpu

Port of ``repro.launch.farm``: builds a data-parallel farm of N chip
replicas (`repro_torch.sim.cluster`), routes a request queue through the
pipelined serving front-end (one chip-axis stacked launch of the
hand-written forward kernel per beat across the whole farm), runs
reconciled data-parallel training steps, and prints aggregate throughput /
energy from the *measured* counters — cross-validated against the summed
per-chip counters and `hw_model.farm_cost` (exits with an error above
1%).  Runs on ``--device cuda`` unless told otherwise; the chip axis is an
array axis on that one device (the reference's device mesh waits for a
multi-GPU host).
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
from repro_torch.core import crossbar as xb, hw_model as hw
from repro_torch.sim.cluster import build_farm


def main(argv: list[str] | None = None) -> None:
    """Run the CLI (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="kdd_anomaly", choices=sorted(NETWORKS))
    ap.add_argument("--chips", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8,
                    help="serving requests routed through the farm")
    ap.add_argument("--train-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch per training step "
                         "(default: one sample per chip)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--share-small-layers", action="store_true")
    ap.add_argument("--reconcile", default="none", choices=["none", "int8"],
                    help="host-link update reconciliation numerics: exact "
                         "sum (== serial chip) or 8-bit sign-magnitude "
                         "codes (matches the metered 8-bit wire format, "
                         "bounded deviation); accounting meters 8-bit "
                         "codes either way")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    farm = build_farm(args.app, args.chips, seed=args.seed,
                      share_small_layers=args.share_small_layers,
                      device=device)
    dims = NETWORKS[args.app]
    batch = args.batch if args.batch is not None else args.chips
    print(f"== {args.app}: {dims} on a {args.chips}-chip farm "
          f"({farm.placement.n_cores} cores/chip, {device}) ==")

    gen = torch.Generator().manual_seed(args.seed + 1)
    if args.requests > 0:
        x = (torch.rand((args.requests, dims[0]), generator=gen)
             - 0.5).to(device)
        out, stats = farm.serve(x)
        ref = xb.mlp_forward(farm.layers(), x, PAPER_SPEC, device=device)
        dev = float((out - ref).abs().max())
        print(f" serve: {args.requests} requests in {stats['beats']} beats "
              f"(beat {stats['beat_us']:.2f} us) -> "
              f"{stats['samples_per_s']:.0f} samples/s steady-state, "
              f"max dev vs mlp_forward {dev:.2e}")

    for step in range(args.train_steps):
        xb_ = (torch.rand((batch, dims[0]), generator=gen) - 0.5).to(device)
        tgt = (torch.rand((batch, dims[-1]), generator=gen) - 0.5).to(device)
        err = farm.train_step(xb_, tgt, lr=args.lr,
                              reconcile=args.reconcile)
        print(f" train step {step}: |err| {float(err.abs().mean()):.4f} "
              f"(replicas in sync: {farm.replicas_in_sync()})")

    rep = farm.report()
    cost = hw.farm_cost(args.app, dims, args.chips,
                        batch_per_chip=max(batch // args.chips, 1),
                        share_small_layers=args.share_small_layers)
    print(f" measured: serve {rep.serve_samples_per_s:.0f} samples/s "
          f"@ {rep.serve_j_per_sample * 1e12:.1f} pJ/sample "
          f"(host link util {rep.host_link_utilization:.3f}); "
          f"train step {rep.train_step_us:.2f} us "
          f"@ {rep.train_j_per_sample * 1e12:.1f} pJ/sample")
    chip_sum = rep.compare_chip_sum()
    cmp_ = rep.compare_hw(cost)
    print(" vs summed per-chip counters: "
          + " ".join(f"{k}={v:.2e}" for k, v in chip_sum.items()))
    print(" cross-validation vs farm_cost (rel err): "
          + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    if rep.serve_samples:
        g_infer = hw.gpu_cost(list(dims), train=False)
        print(f" vs K20 (measured): "
              f"{g_infer.time_us * rep.serve_samples_per_s / 1e6:.1f}x "
              f"serve throughput, "
              f"{g_infer.energy_j / rep.serve_j_per_sample:.0f}x "
              f"energy/sample")
    bad = {k: v for k, v in {**chip_sum, **cmp_}.items() if v > 0.01}
    if bad:
        raise SystemExit(f"farm cross-validation FAILED (>1%): {bad}")

    if args.json:
        record = {"app": args.app, "chips": args.chips, "dims": dims,
                  "rows": rep.rows(), "chip_sum": chip_sum,
                  "cross_validation": cmp_, "device": str(device)}
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
