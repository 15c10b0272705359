"""Projection layers, with optional crossbar-constrained execution (port of
``repro/layers/linear.py``).

Every LM projection goes through ``dense_spec`` / ``dense_apply``.  In
standard mode a projection is one weight tensor and the product is taken
in the compute dtype (a bf16 product returns bf16, as the reference's
does; every product here goes through ``layers.products``, which on the
CPU takes a bf16 product as the fp32 product rounded once).  In crossbar
mode (``XbarMode``) it is a differential conductance pair with
transport-quantized activations (dynamic max-abs fake-quant at
``act_bits``) and an error-quantized backward (``qmatmul``).  A float32
compute dtype means full fp32 products: TF32 stays off (PyTorch's
default for matmuls; ``launch.serve`` and ``chip_smoke.py`` set it off
explicitly).  With
``use_kernel`` the paired product runs on the port's crossbar kernels
(``kernels.ops.crossbar_matmul``).  The serving path runs the standard
mode only.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantization as q
from repro_torch.layers import products
from repro_torch.dist.sharding import ParamSpec, fanin_init, zeros_init


@dataclasses.dataclass(frozen=True)
class XbarMode:
    """Crossbar execution settings for LM projections.

    ``paired=True`` stores the differential pair (G+, G-); ``paired=False``
    the (w, common-mode) reparametrization G± = c ± w/2, whose common mode
    has zero gradient, so only w is a parameter (clipped to ±w_max).
    """
    act_bits: int = 8          # transport quantization of activations
    err_bits: int = 8          # transport quantization of errors
    w_max: float = 4.0         # representable |w| (conductance range)
    paired: bool = True        # store literal (G+, G-) vs (w, common-mode)
    use_kernel: bool = False   # paired projections on the crossbar kernels

    @staticmethod
    def from_config(cfg) -> "XbarMode | None":
        if not getattr(cfg, "crossbar", False):
            return None
        return XbarMode(act_bits=getattr(cfg, "xbar_act_bits", 8),
                        err_bits=getattr(cfg, "xbar_err_bits", 8),
                        w_max=getattr(cfg, "xbar_w_max", 4.0),
                        paired=getattr(cfg, "xbar_paired", True),
                        use_kernel=getattr(cfg, "xbar_use_kernel", False))


def dense_spec(d_in: int, d_out: int, axes: tuple[str | None, str | None],
               *, bias: bool = False, xbar: XbarMode | None = None,
               init=None) -> dict[str, ParamSpec]:
    init = init or fanin_init(0)
    if xbar is None:
        out = {"w": ParamSpec((d_in, d_out), axes, init)}
    elif not xbar.paired:
        def w_init(gen, shape, dtype, device):
            return torch.clamp(init(gen, shape, dtype, device),
                               -xbar.w_max, xbar.w_max)
        out = {"w": ParamSpec((d_in, d_out), axes, w_init)}
    else:
        # Differential pair: two bounded non-negative tensors.  Each draws
        # its own w, as the reference's two initializers do.
        def gp_init(gen, shape, dtype, device):
            w = torch.clamp(init(gen, shape, dtype, device),
                            -xbar.w_max, xbar.w_max)
            return 0.5 * xbar.w_max + 0.5 * w

        def gm_init(gen, shape, dtype, device):
            w = torch.clamp(init(gen, shape, dtype, device),
                            -xbar.w_max, xbar.w_max)
            return 0.5 * xbar.w_max - 0.5 * w

        out = {"g_plus": ParamSpec((d_in, d_out), axes, gp_init),
               "g_minus": ParamSpec((d_in, d_out), axes, gm_init)}
    if bias:
        out["b"] = ParamSpec((d_out,), (axes[1],), zeros_init())
    return out


class _QMatmul(torch.autograd.Function):
    """x @ w whose backward quantizes the error signal to ``err_bits``
    sign-magnitude codes before both transpose products."""

    @staticmethod
    def forward(ctx, x, w, err_bits):
        ctx.save_for_backward(x, w)
        ctx.err_bits = err_bits
        return products.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dyq = q.error_quantize(dy, ctx.err_bits).dequantize().to(dy.dtype)
        dx = products.matmul(dyq, w.T)
        dw = products.einsum("...i,...j->ij", x, dyq).to(w.dtype)
        return dx, dw, None


def qmatmul(x: torch.Tensor, w: torch.Tensor, err_bits: int
            ) -> torch.Tensor:
    """Matmul whose backward error signal is quantized before the transpose
    product (the paper's 8-bit error discretization in autodiff form)."""
    return _QMatmul.apply(x, w, err_bits)


def dense_apply(params: dict[str, torch.Tensor], x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                xbar: XbarMode | None = None) -> torch.Tensor:
    if xbar is None:
        y = products.matmul(x.to(compute_dtype),
                            params["w"].to(compute_dtype))
    elif xbar.use_kernel and "g_plus" in params:
        # the differential-pair subtraction happens inside the fwd kernel;
        # backward runs the bwd + dw kernels on 8-bit error codes
        from repro_torch.kernels import ops as kernel_ops
        xq = q.fake_quant(x.to(compute_dtype), xbar.act_bits)
        y = kernel_ops.crossbar_matmul(
            xq, params["g_plus"].to(compute_dtype),
            params["g_minus"].to(compute_dtype),
            error_quant=True, err_bits=xbar.err_bits)
    else:
        if "w" in params:   # (w, common-mode) reparametrization
            w = params["w"].to(compute_dtype)
        else:               # literal differential pair
            w = (params["g_plus"] - params["g_minus"]).to(compute_dtype)
        xq = q.fake_quant(x.to(compute_dtype), xbar.act_bits)
        y = qmatmul(xq, w, xbar.err_bits)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
    return y
