"""Serving launcher: batched greedy decoding on a random model (port of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --batch 4 --max-new 32 [--device cpu]

``--arch`` takes any architecture of ``configs.list_archs()``: the dense
configs, recurrentgemma-9b, the MoE family (moonshot-v1-16b-a3b,
qwen3-moe-30b-a3b; a decode step routes each slot's token among the
experts, in groups of the batch's tokens, so it drops none),
mamba2-130m (a decode step is the SSD recurrence on a fixed (H, P, N)
state, whatever the length) and seamless-m4t-medium (the decoder, its
cross-attention over the zero cross cache of ``--max-len`` source slots
that ``init_cache`` makes, as the reference's server does).

Parameters are restored from the latest step of ``--ckpt-dir`` (a
checkpoint of ``launch.train``, the port's or the reference's), or else
drawn from ``--seed`` on the run's device.  Runs on ``--device cuda``
unless given ``--device cpu``; without a card the CUDA default raises.  On
the card the server's decode step is one captured CUDA graph (one capture,
then a replay a step; the tokens line counts the captures) and the time is
measured with CUDA events around ``generate``; on the CPU the step runs
eagerly (0 captures) and the time is taken with the host clock.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.runtime import BatchedServer, checkpoint as ckpt


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 compute means full fp32 products, as the reference's: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    model = build_model(cfg, device)
    if args.ckpt_dir:
        restored, step, _ = ckpt.restore(
            args.ckpt_dir, {"params": model.abstract_params(), "opt": None},
            device=device)
        params = restored["params"]
        print(f"restored params from step {step}")
    else:
        params = model.init(torch.Generator(device).manual_seed(args.seed))

    server = BatchedServer(model, params, batch=args.batch,
                           max_len=args.max_len)
    prompts = [[1 + (i * 7 + j) % (cfg.vocab_size - 1) for j in range(8)]
               for i in range(args.batch)]
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = server.generate(prompts, args.max_new)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        outs = server.generate(prompts, args.max_new)
        dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"req{i}: {o[:16]}{'...' if len(o) > 16 else ''}")
    tok = server.stats.tokens_out
    print(f"{tok} tokens in {dt:.2f}s = {tok/dt:.1f} tok/s "
          f"({server.stats.steps} decode steps), {server.captures} "
          f"decode-step captures")


if __name__ == "__main__":
    main()
