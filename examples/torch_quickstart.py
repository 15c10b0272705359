"""Quickstart on the PyTorch/CUDA port: end-to-end LM training on the
synthetic token stream.  Mirrors ``examples/quickstart.py``.

  python examples/torch_quickstart.py [--steps 200] [--arch qwen2-0.5b]
  python examples/torch_quickstart.py --device cpu      # plain versions

Trains the reduced variant of an architecture with checkpointing, then
greedy-decodes a sample.  The full-size configs run through the same code
via ``repro_torch.launch.train``.  Runs on the card unless given
``--device cpu``; there the training step is one captured CUDA graph
(the last line counts its captures; 0 on the CPU, where it runs
eagerly).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.runtime import BatchedServer, Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="ckpts/quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # float32 compute means full fp32 products, as the reference's: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.2f}M")

    lr = cosine_schedule(3e-3, warmup_steps=10, total_steps=args.steps)
    trainer = Trainer(cfg, adamw(lr), ckpt_dir=args.ckpt_dir, ckpt_every=50,
                      device=args.device)
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)
    state, hist = trainer.run(stream, args.steps, log_every=25)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {args.steps} steps")

    model = build_model(cfg, args.device)
    server = BatchedServer(model, state.params, batch=2, max_len=64)
    outs = server.generate([[1, 2, 3, 4], [5, 6, 7, 8]], max_new=16)
    print("sample generations:", outs)
    print(f"{trainer.step.captures} training-step captures")


if __name__ == "__main__":
    main()
