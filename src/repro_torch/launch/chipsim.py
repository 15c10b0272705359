"""Virtual-chip CLI: run a paper application on the simulated multicore
grid, every stage's phase through a hand-written CUDA kernel.

  PYTHONPATH=src python -m repro_torch.launch.chipsim --app mnist_class
  PYTHONPATH=src python -m repro_torch.launch.chipsim --app kdd_anomaly \\
      --samples 16 --share-small-layers --json out.json
  PYTHONPATH=src python -m repro_torch.launch.chipsim --app mnist_class \\
      --train-steps 3 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.chipsim --device cpu \\
      --train-steps 2

Port of ``repro.launch.chipsim``: places the app's Table I network onto the
simulated 400x100 core grid, streams samples through the pipelined stages,
runs ``--train-steps`` on-chip training steps (default 1), and prints
time/energy/throughput from the *measured* simulator counters — including
the cross-validation against `core/hw_model.py` (exits with an error above
1%) and the energy-vs-K20 comparison.  Runs on ``--device cuda`` unless
told otherwise.  Fault injection waits for a later slice of the port.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
from repro_torch.core import crossbar as xb, hw_model as hw
from repro_torch.sim import VirtualChip


def build_chip(app: str, *, share_small_layers: bool = False,
               seed: int = 0,
               device: str | torch.device = "cuda") -> VirtualChip:
    """A VirtualChip holding ``app``'s Table I network with random
    conductances drawn from ``seed`` (on the CPU, so every device gets the
    same weights)."""
    dims = NETWORKS[app]
    gen = torch.Generator().manual_seed(seed)
    layers = [xb.init_conductances(f, o, PAPER_SPEC, generator=gen,
                                   device=device)
              for f, o in zip(dims, dims[1:])]
    return VirtualChip(layers, PAPER_SPEC, name=app,
                       share_small_layers=share_small_layers, device=device)


def main(argv: list[str] | None = None) -> None:
    """Run the CLI (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="kdd_anomaly", choices=sorted(NETWORKS))
    ap.add_argument("--samples", type=int, default=8,
                    help="samples streamed through the recognition pipeline")
    ap.add_argument("--train-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1,
                    help="samples per training step")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--share-small-layers", action="store_true",
                    help="pack consecutive small layers into one core "
                         "(routing-switch loopback, Fig. 2)")
    ap.add_argument("--stuck-on", type=float, default=0.0)
    ap.add_argument("--stuck-off", type=float, default=0.0)
    ap.add_argument("--variation-sigma", type=float, default=0.0)
    ap.add_argument("--json", default=None,
                    help="write the report record to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if args.stuck_on or args.stuck_off or args.variation_sigma:
        raise SystemExit("fault injection is not ported yet "
                         "(ROADMAP Queue 1 item 4)")
    device = resolve_device(args.device)
    chip = build_chip(args.app, share_small_layers=args.share_small_layers,
                      seed=args.seed, device=device)
    dims = NETWORKS[args.app]
    nmap = chip.placement.nmap
    print(f"== {args.app}: {dims} on the virtual chip ({device}) ==")
    print(f" placement: {len(nmap.layers)} stages, {nmap.cores} cores "
          f"({sum(l.total_cores for l in nmap.layers)} core-executions/"
          f"sample), {nmap.routed_outputs} routed outputs/sample")

    gen = torch.Generator().manual_seed(args.seed + 1)
    x = (torch.rand((args.samples, dims[0]), generator=gen) - 0.5).to(device)
    out, stream = chip.infer_stream(x)
    ref = xb.mlp_forward(chip.layers(), x, PAPER_SPEC, device=device)
    dev = float((out - ref).abs().max())
    print(f" inference: {args.samples} samples streamed, max dev vs "
          f"crossbar_apply reference {dev:.2e}")
    print(f" pipeline: beat {stream['beat_us']:.2f} us -> "
          f"{stream['throughput_sps']:.0f} samples/s steady-state "
          f"(occupancy {stream['occupancy']:.2f})")

    for step in range(args.train_steps):
        xb_ = (torch.rand((args.batch, dims[0]), generator=gen)
               - 0.5).to(device)
        tgt = (torch.rand((args.batch, dims[-1]), generator=gen)
               - 0.5).to(device)
        err = chip.train_step(xb_, tgt, lr=args.lr)
        print(f" train step {step}: |err| {float(err.abs().mean()):.4f}")

    rep = chip.report()
    cost = hw.network_cost(args.app, dims,
                           share_small_layers=args.share_small_layers)
    cmp_ = rep.compare_hw(cost)
    gpu = rep.vs_gpu()
    print(f" measured: infer {rep.infer_time_us:.2f} us "
          f"/ {rep.infer_total_j * 1e12:.1f} pJ per sample; "
          f"train {rep.train_time_us:.2f} us "
          f"/ {rep.train_total_j * 1e12:.1f} pJ per sample")
    print(f" cross-validation vs hw_model (rel err): "
          + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    print(f" vs K20 (measured counters): "
          + " ".join(f"{k}={v:.1f}x" for k, v in gpu.items()))
    bad = {k: v for k, v in cmp_.items() if v > 0.01}
    if bad:
        raise SystemExit(f"cross-validation FAILED (>1%): {bad}")

    if args.json:
        record = {"app": args.app, "dims": dims, "cores": rep.cores,
                  "rows": rep.rows(), "cross_validation": cmp_,
                  "vs_gpu": gpu, "device": str(device)}
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
