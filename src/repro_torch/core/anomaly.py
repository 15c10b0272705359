"""Autoencoder anomaly detection (paper section VI.C, Figs 18-20; port of
``repro.core.anomaly``).

Train the AE only on normal traffic; at evaluation, the reconstruction
distance separates normal from attack packets.  The paper reports ~96.6%
detection at ~4% false-positive on KDD with a 41->15->41 network.  Every
function runs on the device of its inputs.

The threshold sweep uses ``torch.linspace``, whose fp32 points may differ
from ``jnp.linspace``'s by an ulp or two (the two formulas round
differently); the rates differ only at a threshold that a score lies that
close to.
"""
from __future__ import annotations

import torch

from repro_torch.core import crossbar as xb
from repro_torch.core.crossbar import CrossbarSpec


def reconstruction_error(layers, x: torch.Tensor, spec: CrossbarSpec
                         ) -> torch.Tensor:
    """Per-sample Manhattan distance between input and reconstruction (the
    paper measures 'distance between original data and reconstructed
    data')."""
    recon = xb.mlp_forward(layers, x, spec, device=x.device)
    return torch.sum(torch.abs(recon - x), dim=-1)


def detection_curve(scores_normal: torch.Tensor, scores_attack: torch.Tensor,
                    n_thresholds: int = 200
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sweep the decision parameter (Fig. 20): returns (thresholds,
    detection_rate, false_positive_rate)."""
    lo = torch.minimum(scores_normal.min(), scores_attack.min())
    hi = torch.maximum(scores_normal.max(), scores_attack.max())
    ts = torch.linspace(float(lo), float(hi), n_thresholds,
                        dtype=scores_normal.dtype,
                        device=scores_normal.device)
    det = (scores_attack[None, :] > ts[:, None]).to(ts.dtype).mean(dim=1)
    fpr = (scores_normal[None, :] > ts[:, None]).to(ts.dtype).mean(dim=1)
    return ts, det, fpr


def detection_at_fpr(scores_normal, scores_attack, max_fpr: float = 0.04
                     ) -> float:
    """Best detection rate achievable at <= max_fpr false positives — the
    paper's '96.6% ... with a 4% false detection rate' operating point."""
    _, det, fpr = detection_curve(scores_normal, scores_attack)
    ok = torch.where(fpr <= max_fpr, det, torch.zeros_like(det))
    return float(torch.max(ok))


def auc(scores_normal: torch.Tensor, scores_attack: torch.Tensor) -> float:
    """Probability an attack scores above a normal sample (rank AUC)."""
    diff = scores_attack[:, None] > scores_normal[None, :]
    ties = scores_attack[:, None] == scores_normal[None, :]
    dtype = scores_attack.dtype
    return float(diff.to(dtype).mean() + 0.5 * ties.to(dtype).mean())
