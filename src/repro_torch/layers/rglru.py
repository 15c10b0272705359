"""Griffin / RecurrentGemma recurrent block (RG-LRU, arXiv:2402.19427;
port of ``repro/layers/rglru.py``).

Recurrence:  a_t = exp(-c * softplus(Lambda) * sigma(r_t))
             h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as the reference's ``jax.lax.associative_scan``
does (``associative_scan``: the same recursion, so the combines associate
as the reference's do; log depth, a few torch ops a level); decode runs
the O(1) step and updates the cache in place (the port's form of the
reference's donated cache), reading nothing back to the host.  The
reference computes the scan in XLA ops, not in a Pallas kernel, so plain
torch is the port's form of it.  The block is the Griffin recurrent
block: a conv + RG-LRU branch gated by a GeLU branch (tanh form, as
``jax.nn.gelu``), both fed from the block input.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import ParamSpec, zeros_init
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.layers.mlp import ACTS

RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    d_conv: int = 4


def _lam_init(gen, shape, dtype, device):
    # a in [0.9, 0.999]:  Lambda = softplus^{-1}(-log(a)/c)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=device) * (0.999 - 0.9) + 0.9
    t = -torch.log(u) / RGLRU_C
    return torch.log(torch.expm1(t)).to(dtype)


def _conv_init(gen, shape, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) / (1.0 * shape[0]) ** 0.5).to(dtype)


def rglru_spec(cfg: RGLRUConfig, xbar: XbarMode | None = None) -> dict:
    d, r = cfg.d_model, cfg.d_rnn
    return {
        "in_proj": dense_spec(d, r, ("fsdp", "heads"), xbar=xbar),
        "gate_proj": dense_spec(d, r, ("fsdp", "heads"), xbar=xbar),
        "conv_w": ParamSpec((cfg.d_conv, r), (None, "heads"), _conv_init),
        "conv_b": ParamSpec((r,), ("heads",), zeros_init()),
        "w_a": dense_spec(r, r, ("heads", None)),      # recurrence gate
        "w_x": dense_spec(r, r, ("heads", None)),      # input gate
        "lam": ParamSpec((r,), (None,), _lam_init),
        "out_proj": dense_spec(r, d, ("heads", "fsdp"), xbar=xbar),
    }


def _gates(params, u: torch.Tensor, compute_dtype: torch.dtype
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) in fp32 from ``u`` in the compute dtype."""
    f32 = torch.float32
    r = torch.sigmoid(dense_apply(params["w_a"], u,
                                  compute_dtype=compute_dtype).to(f32))
    i = torch.sigmoid(dense_apply(params["w_x"], u,
                                  compute_dtype=compute_dtype).to(f32))
    # F.softplus returns x itself above x = 20, where log1p(exp(x)) - x <
    # 2.1e-9 lies below half an fp32 step of x: the same fp32 value as
    # jax.nn.softplus (logaddexp(x, 0))
    log_a = -RGLRU_C * F.softplus(params["lam"].to(f32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u.to(f32))
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Elements of ``even`` at 0, 2, ... and of ``odd`` at 1, 3, ... along
    dim 1 (``even`` as long as ``odd`` or one longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the affine maps h -> a h + b, combined
    as (al, bl) . (ar, br) = (al ar, bl ar + br): the recursion of
    ``jax.lax.associative_scan`` step for step (combine adjacent pairs,
    scan the half-length sequence, fill in the even positions from the
    odd ones), so every element is associated as the reference's is.
    bl ar + br rounds once (``torch.addcmul``), as XLA contracts the
    reference's combine into a fused multiply-add."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_l, a_r = a[:, 0:n - 1:2], a[:, 1::2]
    odd_a, odd_b = associative_scan(
        a_l * a_r, torch.addcmul(b[:, 1::2], b[:, 0:n - 1:2], a_r))
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        odd_a_, odd_b_ = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_, odd_b_ = odd_a, odd_b
    even_a = torch.cat([a[:, :1], odd_a_ * a2], dim=1)
    even_b = torch.cat([b[:, :1], torch.addcmul(b2, odd_b_, a2)], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_apply(params: dict, x: torch.Tensor, cfg: RGLRUConfig, *,
                cache: dict | None = None,
                xbar: XbarMode | None = None,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, L, d).  Decode when ``cache`` is given and L == 1: the cache
    is updated in place and returned.  A prefill with a cache writes the
    last d_conv - 1 inputs and the final state into it."""
    B, L, _ = x.shape
    f32 = torch.float32
    u = dense_apply(params["in_proj"], x, compute_dtype=compute_dtype,
                    xbar=xbar)
    gate = ACTS["gelu"](dense_apply(params["gate_proj"], x,
                                    compute_dtype=compute_dtype, xbar=xbar))
    k = cfg.d_conv

    if cache is not None and L == 1:
        window = torch.cat([cache["conv"], u.to(cache["conv"].dtype)],
                           dim=1)                               # (B, k, C)
        uc = torch.einsum("bkc,kc->bc", window.to(f32),
                          params["conv_w"].to(f32))
        uc = (uc + params["conv_b"].to(f32))[:, None, :]
        a, b = _gates(params, uc.to(compute_dtype), compute_dtype)
        h = a[:, 0] * cache["state"].to(f32) + b[:, 0]
        y = h[:, None, :]
        cache["conv"].copy_(window[:, 1:])
        cache["state"].copy_(h)
        cache["length"].add_(1)
    else:
        up = F.pad(u.to(f32), (0, 0, k - 1, 0))
        w = params["conv_w"].to(f32)
        uc = up[:, 0:L, :] * w[0]          # the taps summed in order i = 0..
        for i in range(1, k):
            uc = uc + up[:, i:i + L, :] * w[i]
        uc = uc + params["conv_b"].to(f32)
        a, b = _gates(params, uc.to(compute_dtype), compute_dtype)
        _, y = associative_scan(a, b)
        if cache is not None:
            cache["conv"].copy_(u[:, -(k - 1):, :])
            cache["state"].copy_(y[:, -1, :])
            cache["length"].add_(L)

    y = y.to(compute_dtype) * gate
    return dense_apply(params["out_proj"], y, compute_dtype=compute_dtype,
                       xbar=xbar), cache


def init_rglru_cache(cfg: RGLRUConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_rnn), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.d_rnn), dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
