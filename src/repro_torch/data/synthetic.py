"""Deterministic synthetic datasets emulating the paper's benchmarks (port
of ``repro.data.synthetic``).

MNIST / ISOLET / KDD / Iris are emulated by Gaussian-mixture generators
with the *same dimensionality and label structure* as the originals.  Every
generator draws from the ``torch.Generator`` it is given, on that
generator's device, and then moves the result to ``device`` (the pattern of
``core.crossbar.init_conductances``): the same seed on a CPU generator
gives the same data on every device.  The streams differ from
``jax.random``'s, so parity tests hand the reference's arrays to the port.

They are calibrated so the paper's qualitative claims are testable:
class-conditional clusters are separable-but-overlapping (classification
converges; k-means finds the structure; anomalies score far from the normal
manifold).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def _labels(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, k, (n,), generator=generator,
                         device=generator.device)


def gaussian_mixture(generator: torch.Generator, n: int, dim: int, k: int,
                     spread: float = 1.0, noise: float = 0.25,
                     data_range: float = 0.5, *,
                     device: str | torch.device = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """k isotropic Gaussian clusters scaled into [-data_range, data_range].

    Inputs live in the crossbar's input voltage range (paper applies inputs
    as sub-threshold voltages), hence the +-0.5 scaling.  Returns
    (x (n, dim) fp32, labels (n,) int64) on ``device``.
    """
    device = resolve_device(device)
    centers = _normal((k, dim), generator) * spread
    labels = _labels(n, k, generator)
    x = centers[labels] + _normal((n, dim), generator) * noise
    x = x / (torch.abs(x).max() + 1e-6) * data_range
    return x.to(device), labels.to(device)


def iris_like(generator: torch.Generator, n: int = 150, *,
              device: str | torch.device = "cuda"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """4-d, 3-class (setosa/versicolor/virginica stand-ins)."""
    return gaussian_mixture(generator, n, dim=4, k=3, spread=1.2, noise=0.35,
                            device=device)


def mnist_like(generator: torch.Generator, n: int = 2048, *,
               device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """784-d, 10-class."""
    return gaussian_mixture(generator, n, dim=784, k=10, spread=1.0,
                            noise=0.4, device=device)


def isolet_like(generator: torch.Generator, n: int = 2048, *,
                device: str | torch.device = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """617-d, 26-class."""
    return gaussian_mixture(generator, n, dim=617, k=26, spread=1.0,
                            noise=0.4, device=device)


def kdd_like(generator: torch.Generator, n_normal: int = 4096,
             n_attack: int = 1024, dim: int = 41, *,
             device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal traffic = a few tight clusters; attacks = off-manifold
    clusters (KDD attack families).  Both sets share ONE normalization
    frame, so attacks stay structurally off-manifold after scaling.
    Returns (normal, attack)."""
    device = resolve_device(device)
    cn = _normal((3, dim), generator) * 0.4
    ca = _normal((4, dim), generator) * 2.0
    ln = _labels(n_normal, 3, generator)
    la = _labels(n_attack, 4, generator)
    normal = cn[ln] + _normal((n_normal, dim), generator) * 0.15
    attack = ca[la] + _normal((n_attack, dim), generator) * 0.35
    scale = torch.maximum(torch.abs(normal).max(),
                          torch.abs(attack).max()) + 1e-6
    return (normal / scale * 0.5).to(device), (attack / scale * 0.5).to(device)


def labeled_targets(labels: torch.Tensor, n_classes: int,
                    lo: float = -0.4, hi: float = 0.4) -> torch.Tensor:
    """One-hot targets in the activation range of h(x) (outputs saturate at
    +-0.5, so targets sit slightly inside), fp32 on ``labels``' device."""
    oh = torch.nn.functional.one_hot(labels.long(), n_classes)
    return oh.to(torch.float32) * (hi - lo) + lo
