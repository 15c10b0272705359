"""Unsupervised big-data pipeline (paper section II) on the PyTorch/CUDA
port: autoencoder dimensionality reduction -> k-means clustering ->
anomaly detection.  Mirrors ``examples/clustering_pipeline.py``.

  python examples/torch_clustering_pipeline.py                # on the card
  python examples/torch_clustering_pipeline.py --device cpu   # plain versions

The k-means assignment runs the hand-written k-means kernel on the card.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.paper_apps import PAPER_SPEC  # noqa: E402
from repro_torch.core import anomaly, autoencoder as ae, kmeans  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402


def run(device: str = "cuda", seed: int = 0, samples: int = 600,
        n_normal: int = 1024, n_attack: int = 256) -> None:
    """The pipeline on ``device``; the generators are seeded ``seed``,
    ``seed + 1``, ... as the reference example keys them."""
    device = resolve_device(device)

    def gen(i):
        return torch.Generator().manual_seed(seed + i)

    print("== dimensionality reduction: 32-d -> 4-d autoencoder ==")
    x, labels = syn.gaussian_mixture(gen(0), samples, dim=32, k=5,
                                     spread=2.0, noise=0.2, device=device)
    enc_layers, _ = ae.pretrain_stack(gen(1), x, [32, 4], PAPER_SPEC,
                                      lr=0.05, epochs=25, batch=16)
    feats = ae.encode(enc_layers, x, PAPER_SPEC)
    print(f" features: {tuple(x.shape)} -> {tuple(feats.shape)}")

    print("== k-means on reduced features (Manhattan, digital core) ==")
    init = kmeans.init_plusplus(gen(2), feats, 5)
    centers, assign, inertia = kmeans.kmeans_fit(
        feats, init, epochs=15, use_kernel=True)
    a, l = assign.cpu(), labels.cpu()
    purity = sum(int(torch.bincount(l[a == c], minlength=5).max())
                 for c in range(5) if (a == c).any()) / len(l)
    print(f" purity={purity:.3f}  inertia {float(inertia[0]):.1f} -> "
          f"{float(inertia[-1]):.1f}")

    print("== anomaly detection on KDD-like traffic (41->15->41 AE) ==")
    normal, attack = syn.kdd_like(gen(3), n_normal, n_attack, device=device)
    enc, dec, _ = ae.pretrain_layer(gen(4), normal, 41, 15, PAPER_SPEC,
                                    lr=0.03, epochs=20, batch=16)
    s_n = anomaly.reconstruction_error([enc, dec], normal, PAPER_SPEC)
    s_a = anomaly.reconstruction_error([enc, dec], attack, PAPER_SPEC)
    det = anomaly.detection_at_fpr(s_n, s_a, max_fpr=0.04)
    print(f" detection at 4% FPR: {det*100:.1f}%  (paper: 96.6%)  "
          f"AUC={anomaly.auc(s_n, s_a):.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, args.seed)


if __name__ == "__main__":
    main()
