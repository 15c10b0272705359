"""The chip farm's reductions over its chip axis (port of the farm's two
functions in ``repro.dist.collectives``).

On one GPU the farm's chips are an array axis, so there is no mesh and no
``axis_name``: each function reduces an explicit leading chip axis.  The
sum runs as an explicit ascending loop over the chips (``c = 0 .. C-1``):
its order is fixed and uses no atomics, so the eager and the compiled farm
reduce identically.  ``compressed_grad_mean`` and ``dp_train_step_fn``
wait for the ``dist/`` slice of the LM stack.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q


def farm_reduce_sum(contrib: torch.Tensor, *, mode: str = "none",
                    err_bits: int = 8) -> torch.Tensor:
    """Reconcile per-chip pulse-update contributions ``contrib`` (C, ...)
    into one farm update (...).

    The chip farm (`repro_torch.sim.cluster`) trains data-parallel: every
    chip computes a LOCAL batch-summed outer product (Eq. 6) and the host
    link carries the contributions to a single reconciled update — the
    paper's pulse discipline applied once, on the SUM, so the replicas stay
    bitwise in lockstep.

    mode "none": fp32 sum in chip order.
    mode "int8": each chip's contribution rides the host link as 8-bit
                 sign-magnitude codes with its OWN full-scale (paper III.F
                 step 1 per chip), so a quiet chip's update survives next
                 to a loud one.
    """
    if mode == "int8":
        def code(g: torch.Tensor) -> torch.Tensor:
            return q.error_quantize(g, err_bits).dequantize()
    elif mode == "none":
        def code(g: torch.Tensor) -> torch.Tensor:
            return g
    else:
        raise ValueError(f"unknown farm reduction mode: {mode!r}")
    out = code(contrib[0])
    for c in range(1, contrib.shape[0]):
        out = out + code(contrib[c])
    return out


def farm_max(x: torch.Tensor) -> torch.Tensor:
    """Farm-wide max over the leading chip axis, kept as size 1.

    The paper's 8-bit error ADC has ONE full-scale per tensor, so the farm
    must agree on max|delta| across all chips before quantizing —
    otherwise each chip would discretize its shard on a different grid and
    the replicas would drift from the serial reference."""
    return torch.amax(x, dim=0, keepdim=True)
