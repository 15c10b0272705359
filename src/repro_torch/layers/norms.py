"""RMSNorm / LayerNorm (port of ``repro/layers/norms.py``): fp32 inside,
output in the input's dtype."""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import ParamSpec, ones_init, zeros_init


def rmsnorm_spec(dim: int) -> dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), (None,), ones_init())}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return y.to(dtype)


def layernorm_spec(dim: int) -> dict[str, ParamSpec]:
    return {"scale": ParamSpec((dim,), (None,), ones_init()),
            "bias": ParamSpec((dim,), (None,), zeros_init())}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-6
                    ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = (y * params["scale"].to(torch.float32)
         + params["bias"].to(torch.float32))
    return y.to(dtype)
