"""Feed-forward blocks: SwiGLU / GeGLU / GELU MLPs (port of
``repro/layers/mlp.py``).  ``gelu`` is the tanh approximation, which is
``jax.nn.gelu``'s default."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec

ACTS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
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
