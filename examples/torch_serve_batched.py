"""Batched serving example on the PyTorch/CUDA port: greedy decoding with
a fixed decode batch.  Mirrors ``examples/serve_batched.py``; its default
architecture is qwen2-0.5b reduced (the reference example's mamba2-130m
is not ported).

  python examples/torch_serve_batched.py                # on the card
  python examples/torch_serve_batched.py --device cpu   # plain versions

Parameters are drawn from ``--seed`` on the run's device.  On the card
the server's decode step is one captured CUDA graph (the last line counts
the captures beside the steps) and the time is measured with CUDA events
around ``generate``; on the CPU the step runs eagerly (0 captures).
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import BatchedServer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 compute means full fp32 products, as the reference's: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced_config(args.arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    server = BatchedServer(model, params, batch=args.batch, max_len=128)

    prompts = [[(i * 13 + j) % (cfg.vocab_size - 1) + 1 for j in range(6)]
               for i in range(args.batch)]
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = server.generate(prompts, args.max_new)
        end.record()
        end.synchronize()
        dt, where = start.elapsed_time(end) / 1e3, torch.cuda.get_device_name(0)
    else:
        t0 = time.perf_counter()
        outs = server.generate(prompts, args.max_new)
        dt, where = time.perf_counter() - t0, "CPU"
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={prompts[i]} -> {o}")
    print(f"{server.stats.tokens_out} tokens in {dt:.2f}s = "
          f"{server.stats.tokens_out/dt:.1f} tok/s on {where} "
          f"({args.arch} reduced) ({server.stats.steps} decode steps), "
          f"{server.captures} decode-step captures")


if __name__ == "__main__":
    main()
