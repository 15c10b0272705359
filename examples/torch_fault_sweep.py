"""Memristor device-fault sweep on the PyTorch/CUDA port's virtual chip
(``repro_torch.sim``).  Mirrors ``memristor_fault_sweep`` of
``examples/fault_tolerant_training.py``.

  python examples/torch_fault_sweep.py                 # on the card
  python examples/torch_fault_sweep.py --device cpu    # plain versions

Trains a small classifier (16 -> 12 -> 4 on a Gaussian mixture) clean
with the paper's training rule, then deploys it onto chips with growing
fractions of stuck memristors — twenty fabricated chips per rate, each a
deterministic seeded fault pattern (the same chip always breaks the same
cells) — and prints the recognition accuracy per rate, which falls as the
stuck fraction grows.
"""
import argparse
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.paper_apps import PAPER_SPEC  # noqa: E402
from repro_torch.core import crossbar as xb  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.runtime.faults import MemristorFaults  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402

RATES = (0.0, 0.01, 0.05, 0.10, 0.20)
CHIPS = 20               # fabricated chips per rate (the reference: 5)


def memristor_fault_sweep(device: str, seed: int) -> dict[float, float]:
    """Accuracy vs device-fault rate; returns {stuck-off rate: mean
    accuracy over the CHIPS chips}."""
    print("== memristor fault sweep (virtual chip) ==")
    x, labels = syn.gaussian_mixture(torch.Generator().manual_seed(seed),
                                     256, dim=16, k=4, spread=1.6,
                                     noise=0.25, device=device)
    y = syn.labeled_targets(labels, 4)
    gen = torch.Generator().manual_seed(seed + 1)
    layers = [xb.init_conductances(f, o, PAPER_SPEC, generator=gen,
                                   device=device)
              for f, o in zip([16, 12, 4], [12, 4])]
    perm_gen = torch.Generator().manual_seed(seed + 2)
    for _ in range(30):
        perm = torch.randperm(256, generator=perm_gen).to(device)
        for s in range(0, 256 - 16 + 1, 16):
            idx = perm[s:s + 16]
            layers, _ = xb.paper_backprop_step(layers, x[idx], y[idx],
                                               PAPER_SPEC, lr=0.8)
    means = {}
    for rate in RATES:
        accs = []
        for chip_seed in range(CHIPS):
            chip = VirtualChip(
                [dict(p) for p in layers], PAPER_SPEC, name="fault_sweep",
                faults=MemristorFaults(stuck_on=rate / 4, stuck_off=rate,
                                       seed=chip_seed), device=device)
            accs.append(float((torch.argmax(chip.infer(x), -1)
                               == labels).float().mean()))
        means[rate] = statistics.mean(accs)
        print(f" stuck fraction {rate:4.0%}: accuracy "
              f"{means[rate]:.3f} +/- {statistics.pstdev(accs):.3f}")
    return means


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    memristor_fault_sweep(args.device, args.seed)


if __name__ == "__main__":
    main()
