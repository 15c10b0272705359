"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches
no device.  The reference's meshes keep their shapes and axis names and
are folded onto one device (``dist.sharding.Mesh``): single pod ("data",
"model") = (16, 16), multi-pod ("pod", "data", "model") = (2, 16, 16).
Both run on ``cuda`` unless the caller passes ``device="cpu"``; without a
card the CUDA default raises.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, resolve_device(device))


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device: str | torch.device = "cuda") -> Mesh:
    """``(n, 1)`` over the visible devices of ``device``'s type (n GPUs;
    one CPU), or ``shape`` as given, folded onto ``device``."""
    device = resolve_device(device)
    if shape is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        shape = (n, 1)
    return Mesh(tuple(shape), tuple(axes), device)
