"""Rotary position embeddings (port of ``repro/layers/rope.py``),
including M-RoPE (Qwen2-VL's 3-section rope).

``apply_rope(x, positions)`` rotates the head_dim of ``x`` (batch, seq,
heads, head_dim) by per-token positions.  ``apply_mrope`` splits the
frequency bands into (t, h, w) sections, each rotated by its own position
stream of ``positions_3d`` (batch, seq, 3).  The model feeds it text
positions only (``text_mrope_positions``: the three streams equal), patch
tokens included, as the reference's model does.

Angles and the rotation are computed in fp32, as the reference does: a
bf16 ``x`` is widened to fp32 for the rotation and the result cast back.
Both rotations take their frequencies from ``_rope_freqs``, equal to the
reference's bit for bit.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The dim/2 fp32 frequencies ``1 / theta ** (2i / dim)``, the
    reference's bit for bit: theta ** e is taken in float64 and rounded
    once to fp32, which equals XLA's fp32 pow at hd 64, 128 and 256 for
    theta 1e4, 1e6 and 5e6 (torch's fp32 pow is an ulp off it in some
    bands, e.g. band 37 at hd 128 and theta 1e6).  They are computed on the
    host, so no device's pow enters, and moved to ``device`` once per
    (dim, theta, device); callers never write to them.  Under a
    ``FakeTensorMode`` (the dry run's trace) they are still made real, so
    the cache never holds a fake tensor."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        exponents = torch.arange(0, dim, 2, dtype=torch.float32) / dim
        freqs = 1.0 / (theta ** exponents.double()).float()
        return freqs.to(device)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> torch.Tensor:
    """positions (..., seq) -> angles (..., seq, dim//2), fp32."""
    return (positions[..., None].to(torch.float32)
            * _rope_freqs(dim, theta, positions.device))


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


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: tuple[int, int, int], *,
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE: positions_3d (batch, seq, 3) = (t, h, w) position streams;
    ``sections`` gives rotary dims (halved) per stream, summing to
    head_dim//2."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    # which stream drives each frequency band: [t]*s0 + [h]*s1 + [w]*s2
    stream = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])
    pos = positions_3d.to(torch.float32)[..., stream]    # (b, s, d/2)
    ang = pos * _rope_freqs(d, theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text tokens: all three streams equal the 1-D position (a view, no
    copy)."""
    return positions[..., None].expand(tuple(positions.shape) + (3,))
