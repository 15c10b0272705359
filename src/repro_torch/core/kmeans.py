"""k-means clustering with Manhattan distance — the digital clustering core
(port of ``repro.core.kmeans``).

Mirrors section IV.B: the hardware core evaluates Manhattan distances to up
to 32 cluster centers (dimension <= 32 after AE reduction) in parallel,
accumulates per-cluster sample sums and counts overlapped with the next
sample's distance calculation, and divides at epoch end to get new centers.

``kmeans_fit`` is the single-device loop.  The assignment step with
``use_kernel`` runs the hand-written CUDA kernel (``kernels/ops``
``kmeans_assign``) on CUDA tensors.  Sums per cluster are a one-hot
product, never an atomic scatter, so they come out the same on every run
(with TF32 off for fp32 products, PyTorch's default).  Every function runs
on the device of its inputs; the seeding draws come from a
``torch.Generator``.

Not ported: the reference's ``distributed_epoch`` (a ``shard_map``/``psum``
building block), which waits for a multi-GPU host.
"""
from __future__ import annotations

import torch

# Hardware core limits (section IV.B) — the kernel tile size.
MAX_CLUSTERS = 32
MAX_DIM = 32


def manhattan_distances(x: torch.Tensor, centers: torch.Tensor
                        ) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) sum |x - c|."""
    return torch.sum(torch.abs(x[:, None, :] - centers[None, :, :]), dim=-1)


def assign(x: torch.Tensor, centers: torch.Tensor, *,
           use_kernel: bool = False) -> torch.Tensor:
    """Index of each sample's nearest center, ties to the lowest index,
    as (n,) int32 (the reference's ``jnp.argmin`` type)."""
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.kmeans_assign(x, centers)
    return torch.argmin(manhattan_distances(x, centers),
                        dim=-1).to(torch.int32)


def accumulate(x: torch.Tensor, assignment: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sample sums and counts (the center-accumulator registers
    and counters of Fig. 13), as the product one_hot(assignment)^T @ x."""
    onehot = torch.nn.functional.one_hot(assignment.long(), k).to(x.dtype)
    sums = onehot.T @ x
    counts = onehot.sum(dim=0)
    return sums, counts


def update_centers(sums: torch.Tensor, counts: torch.Tensor,
                   centers: torch.Tensor) -> torch.Tensor:
    """New centers = accumulated sums / counts; empty clusters keep their
    old center (hardware: divide-by-zero never triggers, the register just
    isn't refreshed)."""
    safe = torch.clamp(counts, min=1.0)[:, None]
    new = sums / safe
    return torch.where(counts[:, None] > 0, new, centers)


def kmeans_fit(x: torch.Tensor, init_centers: torch.Tensor,
               epochs: int = 10, use_kernel: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-batch Lloyd iterations with Manhattan assignment.

    Returns (centers, assignment, inertia_per_epoch).  As in the
    reference, the epochs assign from ``manhattan_distances``; only the
    final assignment honours ``use_kernel``.
    """
    k = init_centers.shape[0]
    centers = init_centers
    inertia = []
    for _ in range(epochs):
        d = manhattan_distances(x, centers)
        a = torch.argmin(d, dim=-1)
        inertia.append(torch.sum(torch.min(d, dim=-1).values))
        sums, counts = accumulate(x, a, k)
        centers = update_centers(sums, counts, centers)
    inertia = torch.stack(inertia) if inertia else x.new_zeros((0,))
    return centers, assign(x, centers, use_kernel=use_kernel), inertia


def init_from_data(generator: torch.Generator, x: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """k distinct rows of x, drawn uniformly without replacement."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=generator.device)[:k]
    return x[idx.to(x.device)]


def plusplus_weights(x: torch.Tensor, centers: torch.Tensor
                     ) -> torch.Tensor:
    """k-means++'s draw probabilities: each sample's Manhattan distance to
    its nearest chosen center, normalised (zero at a chosen center)."""
    d = manhattan_distances(x, centers).min(dim=1).values
    return d / torch.clamp(d.sum(), min=1e-9)


def init_plusplus(generator: torch.Generator, x: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """k-means++ seeding (distance-weighted), Manhattan metric: the first
    center a uniform row of x, each next one a row drawn with the
    probabilities of :func:`plusplus_weights`.  When every row already is
    a center (all weights 0) the draw takes row 0, as the reference's
    inverse-CDF draw does."""
    draw = dict(generator=generator, device=generator.device)
    idx = [int(torch.randint(0, x.shape[0], (), **draw))]
    for _ in range(1, k):
        p = plusplus_weights(x, x[idx]).to(generator.device)
        idx.append(int(torch.multinomial(p, 1, generator=generator))
                   if bool(p.sum() > 0) else 0)
    return x[idx]
