"""Quantizers implementing the paper's transport discretization.

The port of ``repro.core.quantization``.  In-core arithmetic stays analog
(full precision); only what crosses a core boundary is quantized:

  * neuron outputs: 3-bit ADC over the known activation range [-0.5, 0.5]
    (section IV.A),
  * backpropagated errors: 8-bit sign-magnitude (section III.F step 1).

Hard functions serve the communication paths; the ``_ste`` fakes pass
gradients straight through (``x + (q - x).detach()``, the same expression
as the reference's ``stop_gradient`` form, so values round identically).
Deterministic rounding is ``torch.round``, which rounds halves to even as
``jnp.round`` does.  Stochastic rounding takes a ``torch.Generator`` in
place of a ``jax.random`` key: the two draw different bits, so parity tests
hold the stochastic form to its distribution, not to the reference's draws.
"""
from __future__ import annotations

import dataclasses

import torch

# Paper constants.
ADC_BITS = 3          # neuron-output ADC resolution
ERROR_BITS = 8        # sign + 7 magnitude bits
ACT_RANGE = 0.5       # h(x) output range is [-0.5, 0.5]


def _round(x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    if generator is None:
        return torch.round(x)
    noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device)
    return torch.floor(x + noise)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s dtype: dividing by it is an IEEE division
    on every device (a Python-float divisor may become a reciprocal
    multiply on CUDA)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Fixed-range uniform quantizer (the 3-bit output ADC)
# ---------------------------------------------------------------------------

def adc_quantize(x: torch.Tensor, bits: int = ADC_BITS,
                 generator: torch.Generator | None = None,
                 rng_range: float = ACT_RANGE) -> torch.Tensor:
    """Uniform quantization over the fixed range [-rng_range, rng_range].

    Mirrors the hardware ADC: the range is a property of the circuit (the
    op-amp rails), not of the data, so the scale is static.
    """
    levels = 2 ** bits - 1
    scale = (2.0 * rng_range) / levels
    x = torch.clamp(x, -rng_range, rng_range)
    q = _round((x + rng_range) / _scalar(scale, x), generator)
    return q * scale - rng_range


def adc_quantize_ste(x: torch.Tensor, bits: int = ADC_BITS,
                     rng_range: float = ACT_RANGE) -> torch.Tensor:
    """ADC with straight-through gradients (quantization-aware training)."""
    return x + (adc_quantize(x, bits, rng_range=rng_range) - x).detach()


# ---------------------------------------------------------------------------
# Sign-magnitude dynamic-range quantizer (the 8-bit error discretizer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: integer sign-magnitude codes plus a scale.

    ``codes`` are int8/int32 in [-(2^(bits-1)-1), 2^(bits-1)-1]; ``scale`` has
    one entry per block (per-tensor when block covers everything).
    """
    codes: torch.Tensor
    scale: torch.Tensor
    bits: int

    def dequantize(self) -> torch.Tensor:
        """codes * scale in the scale's dtype."""
        return self.codes.to(self.scale.dtype) * self.scale


def error_quantize(x: torch.Tensor, bits: int = ERROR_BITS,
                   generator: torch.Generator | None = None,
                   block_axis: int | None = None) -> QTensor:
    """Paper's error discretization: sign bit + (bits-1) magnitude bits.

    Max-abs scaling per tensor (``block_axis=None``) or per row of
    ``block_axis``; an all-zero block gets scale 1.
    """
    maxmag = 2 ** (bits - 1) - 1
    if block_axis is None:
        scale = torch.amax(torch.abs(x)) / maxmag
    else:
        scale = torch.amax(torch.abs(x), dim=block_axis, keepdim=True) / maxmag
    scale = torch.where(scale == 0, torch.ones_like(scale),
                        scale).to(torch.float32)
    mag = torch.abs(x) / scale
    q = _round(mag, generator)
    q = torch.clamp(q, 0, maxmag) * torch.sign(x)
    dtype = torch.int8 if bits <= 8 else torch.int32
    return QTensor(q.to(dtype), scale, bits)


def error_quantize_ste(x: torch.Tensor, bits: int = ERROR_BITS) -> torch.Tensor:
    """8-bit error quantization with straight-through gradients."""
    return x + (error_quantize(x, bits).dequantize() - x).detach()


# ---------------------------------------------------------------------------
# Generic symmetric fake-quant (used for ablations / beyond-paper bit sweeps)
# ---------------------------------------------------------------------------

def fake_quant(x: torch.Tensor, bits: int,
               per_channel_axis: int | None = None) -> torch.Tensor:
    """Symmetric max-abs fake quantization with STE."""
    maxmag = 2 ** (bits - 1) - 1
    if per_channel_axis is None:
        scale = torch.amax(torch.abs(x)) / maxmag
    else:
        axes = tuple(i for i in range(x.ndim) if i != per_channel_axis)
        scale = torch.amax(torch.abs(x), dim=axes, keepdim=True) / maxmag
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -maxmag, maxmag) * scale
    return x + (q - x).detach()


# ---------------------------------------------------------------------------
# Pulse discretization (the paper's weight-update granularity, section III.F)
# ---------------------------------------------------------------------------

def pulse_discretize(dw: torch.Tensor, max_dw: float, levels: int = 128,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Discretize a weight update into pulse counts: ``levels`` unit pulses
    span ``max_dw`` (section III.F)."""
    unit = max_dw / levels
    q = _round(dw / _scalar(unit, dw), generator)
    q = torch.clamp(q, -levels, levels)
    return q * unit
