"""Rotary position embeddings (port of ``repro/layers/rope.py``;
M-RoPE waits for the VLM slice, ROADMAP Queue 1 item 10).

Angles and the rotation are computed in fp32, as the reference does: a
bf16 ``x`` is widened to fp32 for the rotation and the result cast back.
"""
from __future__ import annotations

import torch


def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (..., seq) -> angles (..., seq, dim//2), fp32."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=positions.device) / dim
    freqs = 1.0 / (theta ** exponents)
    return positions[..., None].to(torch.float32) * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); positions: (batch, seq)."""
    d = x.shape[-1]
    ang = _rope_angles(positions, d, theta)          # (b, s, d/2)
    cos = torch.cos(ang)[..., None, :]               # (b, s, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
