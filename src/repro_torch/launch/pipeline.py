"""Pipeline-fabric CLI: train and serve a network split across chips.

  PYTHONPATH=src python -m repro_torch.launch.pipeline --app isolet_class \\
      --max-cores 100 --requests 8 --train-steps 2 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.pipeline --app mnist_class \\
      --pipeline-chips 2 --n-micro 4 --json pipeline.json
  PYTHONPATH=src python -m repro_torch.launch.pipeline --app isolet_class \\
      --device cpu --check-serial

Port of ``repro.launch.pipeline``: builds a pipeline-parallel fabric
(`repro_torch.sim.fabric`): the network's stage list is split into
contiguous per-chip groups when its core count exceeds one chip's budget
(--max-cores, default the paper's 144-core system), each chip executes its
slice through the hand-written kernels (compiled: one captured CUDA graph
per slice wave and backward pass), and chip-boundary traffic crosses a
modeled inter-chip link under the NoC's quantize-at-the-boundary rule
(3-bit ADC codes forward, 8-bit sign-magnitude errors backward).  With
``--check-serial`` every training step is held bit for bit against the
serial `VirtualChip.train_step` on the unsplit network (exits with an
error on any deviation); serving drains a request queue at one beat per
stage hop.  The run exits with an error if the measured counters disagree
with `hw_model.pipeline_cost` by more than 1% (DESIGN.md §7).  Runs on
``--device cuda`` unless told otherwise; inputs are uniform draws from a
`torch.Generator` seeded ``--seed + 1``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_apps import NETWORKS, PAPER_SPEC
from repro_torch.core import crossbar as xb
from repro_torch.sim.chip import VirtualChip
from repro_torch.sim.fabric import build_pipeline


def main(argv: list[str] | None = None) -> None:
    """Run the CLI (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="isolet_class", choices=sorted(NETWORKS))
    ap.add_argument("--max-cores", type=int, default=None,
                    help="per-chip core budget (default: the paper's "
                         "144-core system when --pipeline-chips unset)")
    ap.add_argument("--pipeline-chips", type=int, default=None,
                    help="split into exactly K chips (balanced) instead "
                         "of by core budget")
    ap.add_argument("--requests", type=int, default=8,
                    help="serving requests drained through the fabric")
    ap.add_argument("--train-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--n-micro", type=int, default=1,
                    help="1F1B microbatches for the schedule time model "
                         "(numerics are the full-batch wave either way)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--share-small-layers", action="store_true")
    ap.add_argument("--check-serial", action="store_true",
                    help="also run the serial unsplit VirtualChip and "
                         "assert bitwise-equal training")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pipe = build_pipeline(args.app, max_cores_per_chip=args.max_cores,
                          n_chips=args.pipeline_chips, seed=args.seed,
                          share_small_layers=args.share_small_layers,
                          device=device)
    dims = NETWORKS[args.app]
    print(f"== {args.app}: {dims} split over {pipe.n_chips} chips "
          f"(cores/chip {[c.placement.n_cores for c in pipe.chips]}, "
          f"boundaries {list(pipe.boundary_dims)}, {device}) ==")

    serial = None
    if args.check_serial:
        serial = VirtualChip(
            [{k: v.clone() for k, v in p.items()} for p in pipe.layers()],
            PAPER_SPEC, name=args.app,
            share_small_layers=args.share_small_layers, device=device)

    gen = torch.Generator().manual_seed(args.seed + 1)
    if args.requests > 0:
        x = (torch.rand((args.requests, dims[0]), generator=gen)
             - 0.5).to(device)
        out, stats = pipe.serve(x)
        ref = xb.mlp_forward(pipe.layers(), x, PAPER_SPEC, device=device)
        dev = float((out - ref).abs().max())
        print(f" serve: {args.requests} requests in {stats['beats']} beats "
              f"(beat {stats['beat_us']:.2f} us, latency "
              f"{stats['latency_us']:.2f} us) -> "
              f"{stats['samples_per_s']:.0f} samples/s steady-state, "
              f"max dev vs mlp_forward {dev:.2e}")

    for step in range(args.train_steps):
        xb_ = (torch.rand((args.batch, dims[0]), generator=gen)
               - 0.5).to(device)
        tgt = (torch.rand((args.batch, dims[-1]), generator=gen)
               - 0.5).to(device)
        err = pipe.train_step(xb_, tgt, lr=args.lr, n_micro=args.n_micro)
        line = f" train step {step}: |err| {float(err.abs().mean()):.4f}"
        if serial is not None:
            err_s = serial.train_step(xb_, tgt, lr=args.lr)
            dev = float((err - err_s).abs().max())
            same = all(torch.equal(a[k], b[k])
                       for a, b in zip(pipe.layers(), serial.layers())
                       for k in ("g_plus", "g_minus"))
            line += (f" (vs serial chip: {dev:.2e}, conductances "
                     f"{'equal' if same else 'DIFFER'})")
            if dev > 0 or not same:
                raise SystemExit(
                    f"pipeline deviated from the serial chip: {dev}, "
                    f"conductances equal: {same}")
        print(line)

    rep = pipe.report()
    print(f" measured: serve {rep.serve_samples_per_s:.0f} samples/s "
          f"@ {rep.serve_j_per_sample * 1e12:.1f} pJ/sample "
          f"(link util {rep.link_utilization:.3f}); "
          f"train step {rep.train_step_us:.2f} us, 1F1B span "
          f"{rep.span_us:.2f} us (n_micro={rep.n_micro}, bubble "
          f"{rep.bubble_fraction:.3f}) "
          f"@ {rep.train_j_per_sample * 1e12:.1f} pJ/sample; "
          f"boundary bits/sample fwd {rep.link_bits_fwd:.0f} "
          f"bwd {rep.link_bits_bwd:.0f}")
    cmp_ = rep.compare_hw()
    print(" cross-validation vs pipeline_cost (rel err): "
          + " ".join(f"{k}={v:.2e}" for k, v in cmp_.items()))
    bad = {k: v for k, v in cmp_.items() if v > 0.01}
    if bad:
        raise SystemExit(f"pipeline cross-validation FAILED (>1%): {bad}")

    if args.json:
        record = {"app": args.app, "chips": pipe.n_chips, "dims": dims,
                  "stage_groups": [list(g) for g in pipe.groups],
                  "rows": rep.rows(), "cross_validation": cmp_,
                  "device": str(device)}
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
