"""Carry conductances and LM parameters between the JAX reference and the
port.

The reference draws its weights with ``jax.random`` and the port with a
``torch.Generator``; the two streams differ, so parity tests hand the
reference's draws to the port through numpy.  This module knows only
numpy and torch: pass it ``np.asarray`` of the reference's arrays (for a
parameter pytree, ``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.sharding import tree_map


def layers_from_numpy(layers: list[dict[str, object]],
                      device: str | torch.device = "cuda"
                      ) -> list[dict[str, torch.Tensor]]:
    """Per-layer ``{"g_plus", "g_minus"}`` array-likes -> float32 tensors
    on ``device`` (values copied exactly)."""
    device = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
             for k, v in p.items()} for p in layers]


def layers_to_numpy(layers: list[dict[str, torch.Tensor]]
                    ) -> list[dict[str, np.ndarray]]:
    """The reverse: per-layer tensors -> numpy float32 arrays on the host."""
    return [{k: v.detach().to("cpu", torch.float32).numpy()
             for k, v in p.items()} for p in layers]


def lm_params_from_numpy(tree, device: str | torch.device = "cuda"):
    """An LM parameter tree of array-likes (nested dicts and tuples, the
    ``stack`` leaves with their leading period axis) -> the same tree of
    tensors on ``device``, leaf for leaf, dtypes and values unchanged."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(device), tree)


def lm_params_to_numpy(tree):
    """The reverse: a tree of tensors -> the same tree of numpy arrays on
    the host (dtypes and values unchanged)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
