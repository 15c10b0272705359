"""The paper's core workflow on the PyTorch/CUDA port: crossbar-constrained
deep-network training.  Mirrors ``examples/crossbar_training.py``.

  python examples/torch_crossbar_training.py                # on the card
  python examples/torch_crossbar_training.py --device cpu   # plain versions

1. Layer-wise autoencoder pretraining (unsupervised, section III.C-E)
2. Supervised fine-tuning with the on-chip BP rule (3-bit transport,
   8-bit errors, pulse updates)
3. Comparison against the unconstrained float implementation (Fig. 21)
4. Core allocation + energy estimate from the hardware model (Tables II-III)
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.paper_apps import FLOAT_SPEC, PAPER_SPEC  # noqa: E402
from repro_torch.core import autoencoder as ae, crossbar as xb  # noqa: E402
from repro_torch.core import hw_model as hw  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402


def run(device: str = "cuda", seed: int = 0) -> None:
    """The workflow on ``device``; the generators are seeded ``seed``,
    ``seed + 1``, ... as the reference example keys them."""
    device = resolve_device(device)

    def gen(i):
        return torch.Generator().manual_seed(seed + i)

    dims = [64, 30, 10]
    x, labels = syn.gaussian_mixture(gen(0), 400, dim=64, k=10, spread=1.5,
                                     noise=0.3, device=device)
    y = syn.labeled_targets(labels, 10)

    print("== layer-wise AE pretraining (constrained) ==")
    enc_layers, curves = ae.pretrain_stack(
        gen(1), x, dims[:-1], PAPER_SPEC, lr=0.05, epochs=20, batch=16)
    for i, c in enumerate(curves):
        print(f" layer {i}: recon mse {float(c[0]):.4f} -> {float(c[-1]):.4f}")

    print("== supervised fine-tuning ==")
    head = xb.init_conductances(dims[-2], dims[-1], PAPER_SPEC,
                                generator=gen(2), device=device)
    layers = enc_layers + [head]
    layers, curve = ae.finetune_supervised(
        gen(3), layers, x, y, PAPER_SPEC, lr=1.0, epochs=120, batch=10)
    out = xb.mlp_forward(layers, x, PAPER_SPEC, device=device)
    acc_c = float((torch.argmax(out, -1) == labels).float().mean())

    fl = ae.init_mlp(gen(2), dims, FLOAT_SPEC, device=device)
    fl, _ = ae.finetune_supervised(gen(3), fl, x, y, FLOAT_SPEC, lr=1.0,
                                   epochs=120, batch=10)
    acc_f = float((torch.argmax(xb.mlp_forward(fl, x, FLOAT_SPEC,
                                               device=device), -1)
                   == labels).float().mean())
    print(f"accuracy constrained={acc_c:.3f} float={acc_f:.3f} "
          f"(Fig. 21 gap: {100*(acc_f-acc_c):.1f} pts)")

    cost = hw.network_cost("example", dims, pretraining=True)
    se = hw.speedup_and_efficiency(cost, dims)
    print(f"hardware model: {cost.cores} cores, "
          f"{cost.train.time_us:.2f} us/sample train, "
          f"{cost.train_total_j:.2e} J/sample, "
          f"{se['train_energy_eff']:.0f}x more energy-efficient than K20")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, args.seed)


if __name__ == "__main__":
    main()
