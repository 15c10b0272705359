"""Plain torch oracles for the ported kernels (mirrors ``repro.kernels.ref``;
the remaining oracles arrive with their kernels)."""
from __future__ import annotations

import torch


def crossbar_fwd_ref(x: torch.Tensor, g_plus: torch.Tensor,
                     g_minus: torch.Tensor, *,
                     activation: bool = True) -> torch.Tensor:
    """y = h(x @ (G+ - G-)); h = hard-sigmoid (paper Eq. 3)."""
    dp = x.to(torch.float32) @ (g_plus - g_minus).to(torch.float32)
    if activation:
        dp = torch.clamp(dp * 0.25, -0.5, 0.5)
    return dp
