"""Carry conductances between the JAX reference and the port.

The reference draws its weights with ``jax.random`` and the port with a
``torch.Generator``; the two streams differ, so parity tests hand the
reference's draws to the port through numpy.  This module knows only
numpy and torch: pass it ``np.asarray`` of the reference's arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


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
