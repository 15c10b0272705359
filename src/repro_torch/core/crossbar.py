"""Memristor-crossbar layer, recognition half (port of ``repro.core.crossbar``).

A crossbar layer models one (possibly tiled) layer of the paper's neural
core:

  * weights are differential conductance pairs ``w = g_plus - g_minus`` with
    conductances bounded in ``[0, w_max]`` (section III.B),
  * the activation is the op-amp hard-sigmoid ``h(x) = clip(x/4, -0.5, 0.5)``
    (Eq. 3 / Fig. 6),
  * inputs arriving over the routing network are 3-bit ADC codes (section
    IV.A),
  * layers larger than a core (400 inputs x 100 neurons) are split across
    tiles; fan-in splits follow Fig. 14 (sub-neurons plus an aggregation
    stage).

This slice ports the forward half.  The reference's custom-VJP
``_xbar_matmul``, ``paper_backprop_step(_scan)`` and ``stack_layers`` belong
to the training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.core import quantization as q

# Paper constants (section IV.A, III.A).
CORE_ROWS = 400      # max fan-in per neural core
CORE_COLS = 100      # max neurons per core (crossbar is 400x200 differential)
G_ON = 1e-4          # 1/R_on,  R_on  = 10 kOhm
G_OFF = 1e-7         # 1/R_off, R_off = 10 MOhm (ratio 1000)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """h(x) = x/4 clipped to [-0.5, 0.5]  (paper Eq. 3, Fig. 6)."""
    return torch.clamp(x * 0.25, -0.5, 0.5)


def hard_sigmoid_deriv(x: torch.Tensor) -> torch.Tensor:
    """h'(x): 1/4 inside the linear region, 0 where h saturates."""
    return torch.where(torch.abs(x) < 2.0, 0.25, 0.0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    """Tile geometry and the transport/update constraints of a network."""
    rows: int = CORE_ROWS            # fan-in capacity of one tile
    cols: int = CORE_COLS            # neuron capacity of one tile
    w_max: float = 1.0               # |w| representable by the conductance pair
    adc_bits: int = q.ADC_BITS       # transport quantization of activations
    err_bits: int = q.ERROR_BITS     # transport quantization of errors
    update_levels: int = 128         # pulse levels per max update (III.F)
    max_update: float = 0.05         # largest single-step |dw| (pulse budget)
    transport_quant: bool = True     # quantize inter-core activations
    error_quant: bool = True         # quantize backpropagated errors
    update_quant: bool = True        # discretize weight updates into pulses
    split_activation: bool = False   # Fig. 14 sub-neuron activation mode

    def tiles(self, fan_in: int, fan_out: int) -> tuple[int, int]:
        """(fan-in tiles, fan-out tiles) of a layer on this geometry."""
        return (math.ceil(fan_in / self.rows), math.ceil(fan_out / self.cols))


# ---------------------------------------------------------------------------
# Conductance <-> weight mapping
# ---------------------------------------------------------------------------

def decompose(w: torch.Tensor, spec: CrossbarSpec
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """w -> (g_plus, g_minus) conductance pair, in weight units, centred on
    the midpoint so the two columns move by +dw/2 and -dw/2."""
    w = torch.clamp(w, -spec.w_max, spec.w_max)
    mid = 0.5 * spec.w_max
    return mid + 0.5 * w, mid - 0.5 * w


def reconstruct(g_plus: torch.Tensor, g_minus: torch.Tensor) -> torch.Tensor:
    """The weight a conductance pair represents: g_plus - g_minus."""
    return g_plus - g_minus


def clip_conductance(g: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """Clamp conductances to the device range [0, w_max]."""
    return torch.clamp(g, 0.0, spec.w_max)


def init_conductances(fan_in: int, fan_out: int, spec: CrossbarSpec, *,
                      generator: torch.Generator,
                      device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """Paper step 1: "Initialize the memristors with high random resistances"
    — small random conductances in [0, 0.02 w_max), hence small random
    weights.  Drawn on ``generator``'s device, then moved to ``device``."""
    device = resolve_device(device)
    hi = 0.02 * spec.w_max
    draw = dict(generator=generator, device=generator.device,
                dtype=torch.float32)
    gp = torch.rand((fan_in, fan_out), **draw) * hi
    gm = torch.rand((fan_in, fan_out), **draw) * hi
    return {"g_plus": gp.to(device), "g_minus": gm.to(device)}


# ---------------------------------------------------------------------------
# The layer (forward)
# ---------------------------------------------------------------------------

def crossbar_apply(params: dict[str, torch.Tensor], x: torch.Tensor,
                   spec: CrossbarSpec, *, activation: bool = True,
                   transport_in: bool = True) -> torch.Tensor:
    """Apply one crossbar layer: y = h( (ADC(x)) @ (g+ - g-) ).

    ``x``: (..., fan_in).  Under exact aggregation the matmul *is* the tiled
    computation, because tile partial sums add linearly (Fig. 14 with a
    linear aggregation stage); ``split_activation=True`` applies h() per
    fan-in tile first.  ``transport_in=False`` marks the network's own
    input, driven through the DAC (section IV.A quantizes neuron outputs,
    not network inputs).
    """
    gp, gm = params["g_plus"], params["g_minus"]
    fan_in = gp.shape[0]
    if spec.transport_quant and transport_in:
        x = q.adc_quantize_ste(x, spec.adc_bits)
    if spec.split_activation and fan_in > spec.rows:
        n_tiles = math.ceil(fan_in / spec.rows)
        pad = n_tiles * spec.rows - fan_in
        xp = torch.nn.functional.pad(x, (0, pad))
        gpp = torch.nn.functional.pad(gp, (0, 0, 0, pad))
        gmp = torch.nn.functional.pad(gm, (0, 0, 0, pad))
        xt = xp.reshape(x.shape[:-1] + (n_tiles, spec.rows))
        gpt = gpp.reshape(n_tiles, spec.rows, gp.shape[1])
        gmt = gmp.reshape(n_tiles, spec.rows, gm.shape[1])
        # sub-neuron DPs -> per-tile activation -> aggregation neuron
        sub = torch.einsum("...tr,trn->...tn", xt, gpt - gmt)
        sub = hard_sigmoid(sub)
        if spec.transport_quant:  # sub-neuron outputs also ride the network
            sub = q.adc_quantize_ste(sub, spec.adc_bits)
        dp = sub.sum(dim=-2) * 4.0  # aggregation neuron with unit weights
    else:
        dp = x @ reconstruct(gp, gm)
    return hard_sigmoid(dp) if activation else dp


def crossbar_dp(params: dict[str, torch.Tensor], x: torch.Tensor,
                spec: CrossbarSpec) -> torch.Tensor:
    """Dot-product (pre-activation) readout — the DP_j the training unit
    re-measures for f'(DP_j) (section III.F step 3)."""
    return crossbar_apply(params, x, spec, activation=False)


def mlp_forward(layers: list[dict[str, torch.Tensor]], x, spec: CrossbarSpec,
                *, use_kernel: bool = False,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Stacked crossbar forward on ``device``.  The network input skips the
    transport ADC (DAC-driven, see crossbar_apply); inter-layer links are
    quantized.

    ``use_kernel=True`` runs the fused inference path: each layer is one
    launch of the hand-written crossbar kernel with the hard-sigmoid *and*
    the output ADC in its epilogue (on CPU tensors, the kernel's plain
    version).
    """
    device = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    layers = [{k: v.to(device) for k, v in p.items()} for p in layers]
    split = spec.split_activation and any(
        p["g_plus"].shape[0] > spec.rows for p in layers)
    if use_kernel and not split:   # sub-neuron stacks: reference path only
        from repro_torch.kernels import ops as kernel_ops
        h = x
        last = len(layers) - 1
        for li, p in enumerate(layers):
            bits = (spec.adc_bits
                    if spec.transport_quant and li < last else None)
            h = kernel_ops.crossbar_fwd(h, p["g_plus"], p["g_minus"],
                                        activation=True, adc_bits=bits)
        return h
    h = x
    for li, p in enumerate(layers):
        h = crossbar_apply(p, h, spec, transport_in=(li > 0))
    return h
