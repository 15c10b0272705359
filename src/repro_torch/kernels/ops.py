"""Public wrappers around the crossbar forward kernel (port of the forward
entry points of ``repro/kernels/ops.py``).

Dispatch: CUDA tensors launch the hand-written kernel
(``crossbar.crossbar_fwd_kernel``) or raise; CPU tensors take the kernel's
plain version (``crossbar.crossbar_fwd_plain``), which plays the role the
reference's interpret mode plays on CPU.  There is no fallback from one to
the other.  Nothing is padded: the kernel masks ragged edges itself.

Each wrapper carries a plain integer ``launches`` that it increments where
it launches the kernel and nowhere else, so a run can show that its main
path went through the kernel.

Not ported yet (ROADMAP): the TPU block autotuner, the tuned-block table
and the conductance pad cache (reference ``ops.py:60-255``), which tile for
the TPU's VMEM; the training wrappers (bwd, dw, pulse, fused train,
``crossbar_matmul``) and the k-means and attention wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import crossbar as xbk


def _run_fwd(wrapper, xs, g_plus, g_minus, **epilogue) -> torch.Tensor:
    """(T, M, K) stack through the plain version (CPU) or the kernel."""
    if all(t.device.type == "cpu" for t in (xs, g_plus, g_minus)):
        return xbk.crossbar_fwd_plain(xs, g_plus, g_minus, **epilogue)
    y = xbk.crossbar_fwd_kernel(xs.contiguous(), g_plus.contiguous(),
                                g_minus.contiguous(), **epilogue)
    wrapper.launches += 1
    return y


def crossbar_fwd(x: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, *, activation: bool = True,
                 adc_bits: int | None = None,
                 adc_range: float = 0.5) -> torch.Tensor:
    """y = ADC(h(x @ (G+ - G-))).  x (..., K); g± (K, N) -> (..., N).

    ``adc_bits`` enables the fused output-ADC epilogue (transport
    quantization without a separate op between layers)."""
    lead = x.shape[:-1]
    K, N = g_plus.shape
    y = _run_fwd(crossbar_fwd, x.reshape(1, -1, K), g_plus[None],
                 g_minus[None], activation=activation, adc_bits=adc_bits,
                 adc_range=adc_range)
    return y.reshape(*lead, N)


crossbar_fwd.launches = 0


def _fold_chip_axis(*arrays):
    """Fold an optional leading chip axis into the core-stack axis.

    All arrays must share ndim (3 = no chip axis, 4 = (C, T, ...)).
    Returns (folded_arrays, unfold) where ``unfold(y)`` restores the chip
    axis on a (C*T, ...) result."""
    ndims = {a.dim() for a in arrays}
    if ndims == {3}:
        return arrays, lambda y: y
    if ndims != {4}:
        raise ValueError(f"stacked operands must all be rank 3 or all "
                         f"rank 4, got ndims {sorted(ndims)}")
    C = arrays[0].shape[0]
    if any(a.shape[0] != C for a in arrays):
        raise ValueError("mismatched chip axis across stacked operands")
    folded = tuple(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
                   for a in arrays)
    return folded, lambda y: y.reshape((C, y.shape[0] // C) + y.shape[1:])


def crossbar_fwd_stacked(xs: torch.Tensor, g_plus: torch.Tensor,
                         g_minus: torch.Tensor, *, activation: bool = False,
                         adc_bits: int | None = None,
                         adc_range: float = 0.5) -> torch.Tensor:
    """Batched multi-core forward: one launch evaluates T crossbars.

    xs (T, M, K); g± (T, K, N) -> (T, M, N).  Core t computes
    ``xs[t] @ (g_plus[t] - g_minus[t])`` — the per-stage dispatch of the
    virtual chip, where slice t is one physical core's conductance array.
    A leading chip axis — xs (C, T, M, K); g± (C, T, K, N) — folds into the
    core stack, so a whole farm executes as the same single launch.
    """
    (xs, g_plus, g_minus), unfold = _fold_chip_axis(xs, g_plus, g_minus)
    return unfold(_run_fwd(crossbar_fwd_stacked, xs, g_plus, g_minus,
                           activation=activation, adc_bits=adc_bits,
                           adc_range=adc_range))


crossbar_fwd_stacked.launches = 0
