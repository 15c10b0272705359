"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 200 --batch 8 --seq 128 [--crossbar] \\
      [--ckpt-dir ckpts/run0] [--device cpu]

``--arch`` takes any architecture of ``configs.list_archs()``; an MoE
config's loss is the cross-entropy plus its load-balancing term (the
logged ``aux``); mamba2-130m trains its SSD blocks through the chunked
scan, each chunk rematerialized.  The encoder-decoder seamless-m4t-medium
needs batches that carry ``src_frames``, which ``TokenStream`` does not
make, so the CLI refuses it (as the reference's cannot train it either):
train it through ``make_train_step`` or ``Trainer`` on such batches.
Runs on ``--device cuda`` unless given ``--device cpu``; without a card
the CUDA default raises.  TF32 stays off, so float32 compute means full
fp32 products.  ``--mesh host|single|multi`` builds the reference's mesh
(``launch/mesh.py``: ``(n, 1)`` over the visible devices, or the
production ``(16, 16)`` / ``(2, 16, 16)``) folded onto the device, and
trains on it with the reference's shardings.  On the card the
``Trainer``'s step is one captured CUDA graph (``runtime.train_loop.
TrainStep``): the first step warms up and captures, every later one
replays; the line before the last counts the captures (1 on the card, 0
on the CPU, where the step runs eagerly).
"""
from __future__ import annotations

import argparse
import logging

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import Trainer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--crossbar", action="store_true",
                    help="enable the paper's crossbar execution mode")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "pulse_sgd"])
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    # float32 compute means full fp32 products, as the reference's: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if cfg.family == "encdec":
        raise SystemExit(f"--arch {args.arch}: an encoder-decoder trains on "
                         f"batches with src_frames, which TokenStream does "
                         f"not make; use make_train_step or Trainer on such "
                         f"batches")
    if args.crossbar:
        cfg = cfg.replace(crossbar=True)

    mesh = None
    if args.mesh == "host":
        mesh = make_host_mesh(device=device)
    elif args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                    device=device)

    lr = cosine_schedule(args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps)
    opt = make_optimizer(args.optimizer, lr)
    trainer = Trainer(cfg, opt, mesh=mesh, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, seed=args.seed,
                      device=device)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    state, hist = trainer.run(stream, args.steps)
    print(f"{trainer.step.captures} training-step captures")
    print(f"final step {state.step}: loss {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f})")
    if trainer.watchdog.events:
        print(f"straggler events: {trainer.watchdog.events}")


if __name__ == "__main__":
    main()
