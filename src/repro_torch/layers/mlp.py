"""Feed-forward blocks: SwiGLU / GeGLU / GELU MLPs (port of
``repro/layers/mlp.py``).  ``gelu`` is the tanh approximation, which is
``jax.nn.gelu``'s default, computed as the reference computes it
(``gelu_tanh``); ``silu`` is ``jax.nn.silu`` as XLA evaluates it
(``silu``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (the tanh form) op for op in x's dtype, its
    constants sqrt(2/pi) and 0.044715 first rounded to that dtype, as
    the reference evaluates it: x * (0.5 * (1 + tanh(c * (x + k * x^3)))),
    x^3 as (x * x) * x.  In bf16 every op rounds (0.7978846 becomes
    0.796875); ``F.gelu`` rounds once, and about 40 % of its bf16 outputs
    then lie a step away from the reference's."""
    c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` as XLA evaluates it, 1 / (1 + exp(-x)) with
    every op rounded to x's dtype, and its gradient by JAX's rule for
    ``logistic``, g * (s * (1 - s)), also op for op."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu(x)`` = x * sigmoid(x) op for op in x's dtype, forward
    and backward.  In bf16 every op rounds, as XLA's expansion of the
    logistic does; ``F.silu`` rounds once, and about 39 % of its bf16
    outputs then lie a step away from the reference's."""
    return x * _Logistic.apply(x)


ACTS = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
}


def mlp_spec(d_model: int, d_ff: int, *, gated: bool = True,
             xbar: XbarMode | None = None) -> dict:
    spec = {
        "wi": dense_spec(d_model, d_ff, ("fsdp", "ff"), xbar=xbar),
        "wo": dense_spec(d_ff, d_model, ("ff", "fsdp"), xbar=xbar),
    }
    if gated:
        spec["wg"] = dense_spec(d_model, d_ff, ("fsdp", "ff"), xbar=xbar)
    return spec


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu",
              xbar: XbarMode | None = None,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    h = dense_apply(params["wi"], x, compute_dtype=compute_dtype, xbar=xbar)
    if "wg" in params:
        g = dense_apply(params["wg"], x, compute_dtype=compute_dtype,
                        xbar=xbar)
        h = ACTS[act](g) * h
    else:
        h = ACTS[act](h)
    return dense_apply(params["wo"], h, compute_dtype=compute_dtype,
                       xbar=xbar)
