"""Memristor-crossbar layer (port of ``repro.core.crossbar``).

A crossbar layer models one (possibly tiled) layer of the paper's neural
core:

  * weights are differential conductance pairs ``w = g_plus - g_minus`` with
    conductances bounded in ``[0, w_max]`` (section III.B),
  * the activation is the op-amp hard-sigmoid ``h(x) = clip(x/4, -0.5, 0.5)``
    (Eq. 3 / Fig. 6),
  * inputs arriving over the routing network are 3-bit ADC codes (section
    IV.A), modeled as fixed-range fake-quant with STE,
  * backpropagated errors are 8-bit sign-magnitude (section III.F step 1) and
    travel through the *same* weights (Eq. 7 / Fig. 9) — modeled with a
    ``torch.autograd.Function`` whose backward quantizes the incoming error
    before the transpose product,
  * layers larger than a core (400 inputs x 100 neurons) are split across
    tiles; fan-in splits follow Fig. 14 (sub-neurons plus an aggregation
    stage).

The paper's manual training rule (``paper_backprop_step``, and the stacked
``paper_backprop_step_scan`` on the kernels) updates the conductances with
pulse-discretized outer products (section III.F).
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
# Forward/backward with transport quantization (custom autograd)
# ---------------------------------------------------------------------------

class _XbarMatmul(torch.autograd.Function):
    """y = x @ (g+ - g-); the backward quantizes the incoming error to
    ``spec.err_bits`` sign-magnitude codes before the transpose product."""

    @staticmethod
    def forward(ctx, x, g_plus, g_minus, spec):
        w = reconstruct(g_plus, g_minus)
        ctx.save_for_backward(x, w)
        ctx.spec = spec
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if ctx.spec.error_quant:
            # Paper III.F step 1: errors discretized to 8 bits before being
            # driven back through the crossbar columns (Fig. 9).
            dy = q.error_quantize(dy, ctx.spec.err_bits).dequantize()
        dx = dy @ w.T                     # Eq. 7: delta_prev = W^T delta
        dw = torch.einsum("...i,...j->ij", x, dy)   # Eq. 6, batch-summed
        # d/dg_plus = +dw, d/dg_minus = -dw: the two columns move
        # oppositely, matching the +dw/2 / -dw/2 hardware update.
        return dx, dw, -dw, None


def _xbar_matmul(x: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """x @ (g+ - g-) with the 8-bit error transport in its backward."""
    return _XbarMatmul.apply(x, g_plus, g_minus, spec)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def crossbar_apply(params: dict[str, torch.Tensor], x: torch.Tensor,
                   spec: CrossbarSpec, *, activation: bool = True,
                   use_kernel: bool = False,
                   transport_in: bool = True) -> torch.Tensor:
    """Apply one crossbar layer: y = h( (ADC(x)) @ (g+ - g-) ).

    ``x``: (..., fan_in).  Under exact aggregation the matmul *is* the tiled
    computation, because tile partial sums add linearly (Fig. 14 with a
    linear aggregation stage); ``split_activation=True`` applies h() per
    fan-in tile first.  ``transport_in=False`` marks the network's own
    input, driven through the DAC (section IV.A quantizes neuron outputs,
    not network inputs).

    ``use_kernel=True`` routes through the differentiable kernel path
    (``kernels/ops.crossbar_matmul``): forward, error backprop (8-bit codes
    dequantized in the kernel) and the weight outer product all run as
    kernels under ``torch.autograd``.
    """
    gp, gm = params["g_plus"], params["g_minus"]
    fan_in = gp.shape[0]
    if spec.transport_quant and transport_in:
        x = q.adc_quantize_ste(x, spec.adc_bits)
    # Fig.-14 sub-neuron mode changes the network function per fan-in tile;
    # the kernels implement exact aggregation only, so split stacks fall
    # through to the reference path rather than compute a different model.
    if use_kernel and not (spec.split_activation and fan_in > spec.rows):
        from repro_torch.kernels import ops as kernel_ops
        dp = kernel_ops.crossbar_matmul(x, gp, gm,
                                        error_quant=spec.error_quant,
                                        err_bits=spec.err_bits)
        return hard_sigmoid(dp) if activation else dp
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
        dp = _xbar_matmul(x, gp, gm, spec)
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


# ---------------------------------------------------------------------------
# The paper's manual training rule (pulse-based update, section III.E/III.F)
# ---------------------------------------------------------------------------

def paper_backprop_step(layers: list[dict[str, torch.Tensor]],
                        x: torch.Tensor, target: torch.Tensor,
                        spec: CrossbarSpec, lr: float,
                        generator: torch.Generator | None = None
                        ) -> tuple[list[dict[str, torch.Tensor]],
                                   torch.Tensor]:
    """One stochastic-BP step exactly as the hardware executes it.

    The literal Eq. 4-6 loop with transport/error/update quantization.
    ``generator`` selects stochastic pulse rounding (the reference's
    ``key``); ``None`` rounds to nearest.  Returns (updated_layers,
    output_error).
    """
    # -- forward, recording per-layer inputs and DPs (III.F step 1).  Layer
    # 0's input is the network input, driven through the DAC: only
    # inter-core activations see the 3-bit output ADC (section IV.A).
    acts = [x]
    dps = []
    h = x
    for li, p in enumerate(layers):
        if spec.transport_quant and li > 0:
            h = q.adc_quantize_ste(h, spec.adc_bits)
            acts[-1] = h
        dp = h @ reconstruct(p["g_plus"], p["g_minus"])
        dps.append(dp)
        h = hard_sigmoid(dp)
        acts.append(h)

    # -- output error (Eq. 4)
    delta = target - acts[-1]

    new_layers = [dict(p) for p in layers]
    for li in reversed(range(len(layers))):
        p = layers[li]
        w = reconstruct(p["g_plus"], p["g_minus"])
        if spec.error_quant:
            delta = q.error_quantize(delta, spec.err_bits).dequantize()
        local = delta * hard_sigmoid_deriv(dps[li])      # delta_j * f'(DP_j)
        dw = 2.0 * lr * torch.einsum("...i,...j->ij", acts[li], local)
        if acts[li].dim() > 1:   # batched: average the per-sample updates
            dw = dw / q._scalar(math.prod(acts[li].shape[:-1]), dw)
        if spec.update_quant:
            dw = q.pulse_discretize(dw, spec.max_update, spec.update_levels,
                                    generator)
        new_layers[li] = {
            "g_plus": clip_conductance(p["g_plus"] + 0.5 * dw, spec),
            "g_minus": clip_conductance(p["g_minus"] - 0.5 * dw, spec),
        }
        # back-propagate through this layer's weights (Eq. 5 / Fig. 9)
        delta = local @ w.T
    return new_layers, target - acts[-1]


# ---------------------------------------------------------------------------
# Stacked equal-shaped layers (the kernel hot loop)
# ---------------------------------------------------------------------------

def stack_layers(layers: list[dict[str, torch.Tensor]]
                 ) -> dict[str, torch.Tensor]:
    """Stack equal-shaped layer dicts into (L, fan_in, fan_out) buffers for
    :func:`paper_backprop_step_scan`.  Raises if shapes are ragged (use the
    per-layer ``paper_backprop_step`` for ragged stacks)."""
    shapes = {tuple(p["g_plus"].shape) for p in layers}
    if len(shapes) != 1:
        raise ValueError(f"scan pipeline needs equal-shaped layers, got "
                         f"{sorted(shapes)}")
    return {"g_plus": torch.stack([p["g_plus"] for p in layers]),
            "g_minus": torch.stack([p["g_minus"] for p in layers])}


def unstack_layers(stacked: dict[str, torch.Tensor]
                   ) -> list[dict[str, torch.Tensor]]:
    """(L, fan_in, fan_out) buffers -> per-layer dicts (views)."""
    L = stacked["g_plus"].shape[0]
    return [{"g_plus": stacked["g_plus"][i],
             "g_minus": stacked["g_minus"][i]} for i in range(L)]


def paper_backprop_step_scan(stacked: dict[str, torch.Tensor],
                             x: torch.Tensor, target: torch.Tensor,
                             spec: CrossbarSpec, lr: float,
                             use_kernel: bool = True
                             ) -> tuple[dict[str, torch.Tensor],
                                        torch.Tensor]:
    """One stochastic-BP step over stacked equal-shaped layers.

    Same semantics as :func:`paper_backprop_step` with deterministic pulse
    rounding, ``lr`` divided by the batch before the product: a forward
    loop recording per-layer inputs and DPs, then a reversed loop whose body
    runs the bwd kernel (error transpose-product) and the pulse-update
    kernel (or, with ``update_quant=False``, the dw kernel) per layer when
    ``use_kernel``.  The stacked conductances are written IN PLACE
    (``copy_``), the port's form of the reference's buffer donation; the
    returned dict is ``stacked`` itself.
    """
    from repro_torch.kernels import ops as kernel_ops

    batch = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
    lr_eff = lr / batch
    layers = unstack_layers(stacked)

    acts, dps = [], []
    h = out = x
    for p in layers:
        if use_kernel:
            dp = kernel_ops.crossbar_fwd(h, p["g_plus"], p["g_minus"],
                                         activation=False)
        else:
            dp = h @ reconstruct(p["g_plus"], p["g_minus"])
        acts.append(h)
        dps.append(dp)
        out = hard_sigmoid(dp)
        # transport-quantize at the core boundary; the last layer's output
        # goes to the training unit, not the network.
        h = (q.adc_quantize_ste(out, spec.adc_bits)
             if spec.transport_quant else out)
    delta = target - out

    for p, a, dp in zip(reversed(layers), reversed(acts), reversed(dps)):
        if spec.error_quant:
            delta = q.error_quantize(delta, spec.err_bits).dequantize()
        local = delta * hard_sigmoid_deriv(dp)
        if use_kernel:
            if spec.update_quant:
                gp, gm = kernel_ops.pulse_update(
                    p["g_plus"], p["g_minus"], a, local, lr=lr_eff,
                    max_dw=spec.max_update, levels=spec.update_levels,
                    w_max=spec.w_max)
            else:
                # continuous (non-pulsed) update, outer product on-kernel
                dw = 2.0 * lr_eff * kernel_ops.crossbar_dw(a, local)
                gp = clip_conductance(p["g_plus"] + 0.5 * dw, spec)
                gm = clip_conductance(p["g_minus"] - 0.5 * dw, spec)
            delta_prev = kernel_ops.crossbar_bwd(local, p["g_plus"],
                                                 p["g_minus"])
        else:
            dw = 2.0 * lr_eff * torch.einsum("...i,...j->ij", a, local)
            if spec.update_quant:
                dw = q.pulse_discretize(dw, spec.max_update,
                                        spec.update_levels, None)
            gp = clip_conductance(p["g_plus"] + 0.5 * dw, spec)
            gm = clip_conductance(p["g_minus"] - 0.5 * dw, spec)
            delta_prev = local @ reconstruct(p["g_plus"], p["g_minus"]).T
        # the error has left through the old conductances: update in place
        p["g_plus"].copy_(gp)
        p["g_minus"].copy_(gm)
        delta = delta_prev
    return stacked, target - out
