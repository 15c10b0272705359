"""Plain torch oracles for the ported kernels (mirrors
``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_plain


def crossbar_fwd_ref(x: torch.Tensor, g_plus: torch.Tensor,
                     g_minus: torch.Tensor, *,
                     activation: bool = True) -> torch.Tensor:
    """y = h(x @ (G+ - G-)); h = hard-sigmoid (paper Eq. 3)."""
    dp = x.to(torch.float32) @ (g_plus - g_minus).to(torch.float32)
    if activation:
        dp = torch.clamp(dp * 0.25, -0.5, 0.5)
    return dp


def crossbar_bwd_ref(dy: torch.Tensor, g_plus: torch.Tensor,
                     g_minus: torch.Tensor) -> torch.Tensor:
    """dx = dy @ (G+ - G-)^T  (paper Eq. 7, backward through the crossbar)."""
    w = (g_plus - g_minus).to(torch.float32)
    return dy.to(torch.float32) @ w.T


def crossbar_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw = x^T @ dy (paper Eq. 6 outer product, batch-summed)."""
    return x.to(torch.float32).T @ dy.to(torch.float32)


def pulse_update_ref(g_plus: torch.Tensor, g_minus: torch.Tensor,
                     x: torch.Tensor, delta: torch.Tensor, *, lr: float,
                     max_dw: float, levels: int, w_max: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper III.F step 3: dw = 2*lr*(x^T @ delta), discretized into unit
    pulses; columns move +dw/2 / -dw/2; conductances clip to [0, w_max]."""
    dw = 2.0 * lr * (x.to(torch.float32).T @ delta.to(torch.float32))
    unit = max_dw / levels
    dw = torch.clamp(torch.round(dw / unit), -levels, levels) * unit
    gp = torch.clamp(g_plus + 0.5 * dw, 0.0, w_max)
    gm = torch.clamp(g_minus - 0.5 * dw, 0.0, w_max)
    return gp, gm


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Naive softmax attention oracle at scale hd ** -0.5 (the reference
    oracle's signature).  q (B,Sq,H,hd); k/v (B,Skv,K,hd)."""
    return flash_attention_plain(q, k, v, scale=q.shape[-1] ** -0.5,
                                 causal=causal)


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Manhattan-distance argmin assignment (paper Fig. 13)."""
    d = torch.sum(torch.abs(x[:, None, :].to(torch.float32)
                            - centers[None, :, :].to(torch.float32)), dim=-1)
    return torch.argmin(d, dim=-1).to(torch.int32)
