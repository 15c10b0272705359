"""The paper's applications end-to-end on the PyTorch/CUDA port's virtual
chip (``repro_torch.sim``).  Mirrors ``examples/chip_sim.py``.

  python examples/torch_chip_sim.py                 # on the card
  python examples/torch_chip_sim.py --device cpu    # plain versions

Runs the three Table I application families — classification, autoencoder
dimensionality reduction, and anomaly detection — *on the simulated
multicore chip*: training executes the paper's fwd/bwd/update phases on
stacked crossbar cores (on the card, the hand-written crossbar kernels
inside one captured CUDA graph per step shape), inference streams through
the pipelined stages, and the energy-vs-K20 comparison at the end comes
from the simulator's measured counters, not from the analytic constants.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.paper_apps import PAPER_SPEC  # noqa: E402
from repro_torch.core import anomaly, hw_model as hw  # noqa: E402
from repro_torch.core import crossbar as xb  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.sim import VirtualChip  # noqa: E402


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _chip(dims, name, seed, device):
    gen = _gen(seed)
    layers = [xb.init_conductances(f, o, PAPER_SPEC, generator=gen,
                                   device=device)
              for f, o in zip(dims, dims[1:])]
    return VirtualChip(layers, PAPER_SPEC, name=name, device=device)


def _train(chip, x, y, lr, epochs, batch, seed):
    n = x.shape[0]
    gen = _gen(seed)
    for _ in range(epochs):
        perm = torch.randperm(n, generator=gen).to(x.device)
        for s in range(0, n - batch + 1, batch):
            idx = perm[s:s + batch]
            chip.train_step(x[idx], y[idx], lr=lr)


def _summary(chip):
    rep = chip.report()
    gpu = rep.vs_gpu()
    print(f"  measured: train {rep.train_time_us:.2f} us "
          f"/ {rep.train_total_j * 1e12:.1f} pJ per sample; stream "
          f"{rep.throughput_sps:.0f} samples/s; "
          f"{gpu['train_energy_eff']:.0f}x more energy-efficient than "
          f"K20 training, {gpu.get('infer_energy_eff', 0):.0f}x at "
          f"recognition")
    return rep


def classification(device, seed):
    print("== classification (gaussian mixture, 16 -> 12 -> 4) ==")
    x, labels = syn.gaussian_mixture(_gen(seed), 256, dim=16, k=4,
                                     spread=1.6, noise=0.25, device=device)
    y = syn.labeled_targets(labels, 4)
    chip = _chip([16, 12, 4], "classification", seed + 1, device)
    _train(chip, x, y, lr=0.8, epochs=30, batch=16, seed=seed + 2)
    out, stream = chip.infer_stream(x)
    acc = float((torch.argmax(out, -1) == labels).float().mean())
    print(f"  accuracy {acc:.3f} "
          f"(beat {stream['beat_us']:.2f} us, "
          f"occupancy {stream['occupancy']:.2f})")
    _summary(chip)


def autoencoder(device, seed):
    print("== autoencoder dimensionality reduction (16 -> 6 -> 16) ==")
    x, _ = syn.gaussian_mixture(_gen(seed + 3), 256, dim=16, k=4,
                                spread=1.4, noise=0.2, device=device)
    chip = _chip([16, 6, 16], "autoencoder", seed + 4, device)
    mse0 = float(((chip.infer(x, count=False) - x) ** 2).mean())
    _train(chip, x, x, lr=0.4, epochs=30, batch=16, seed=seed + 5)
    mse1 = float(((chip.infer(x) - x) ** 2).mean())
    print(f"  recon mse {mse0:.4f} -> {mse1:.4f}")
    _summary(chip)


def anomaly_detection(device, seed):
    print("== anomaly detection (KDD-like, 41 -> 15 -> 41) ==")
    normal, attack = syn.kdd_like(_gen(seed + 6), n_normal=512,
                                  n_attack=128, device=device)
    chip = _chip(hw.PAPER_NETWORKS["kdd_anomaly"], "kdd_anomaly", seed + 7,
                 device)
    _train(chip, normal, normal, lr=0.3, epochs=8, batch=16, seed=seed + 8)
    # score ON the chip: reconstruction distance from streamed inference
    s_n = torch.abs(chip.infer(normal) - normal).sum(-1)
    s_a = torch.abs(chip.infer(attack) - attack).sum(-1)
    det = anomaly.detection_at_fpr(s_n, s_a, max_fpr=0.04)
    print(f"  detection at 4% FPR: {det:.3f} "
          f"(AUC {anomaly.auc(s_n, s_a):.3f})")
    rep = _summary(chip)
    err = rep.compare_hw(hw.network_cost("kdd_anomaly",
                                         hw.PAPER_NETWORKS["kdd_anomaly"]))
    worst = max(err.values())
    print(f"  sim<->hw_model cross-validation: worst rel err {worst:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    classification(args.device, args.seed)
    autoencoder(args.device, args.seed)
    anomaly_detection(args.device, args.seed)


if __name__ == "__main__":
    main()
