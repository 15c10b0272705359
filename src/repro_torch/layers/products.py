"""Matrix products of the LM layers in the compute dtype.

On the card a bf16 product is the library's bf16 product (fp32
accumulation, one rounding to bf16).  On the CPU a bf16 (or fp16)
product is taken as the fp32 product of the operands' exact fp32 values,
rounded once to the operands' dtype.  That is the reference's program on
the CPU (XLA converts a bf16 dot's operands to f32, takes the f32 dot and
converts the result back), and it keeps the product away from oneDNN's
multithreaded AMX bf16 GEMM, which in some processes returns NaN or
wrong values from finite operands.  The result is finite whenever the
operands are, and the same from run to run and process to process.
Under autograd the fp32 form's backward is the same rule: each gradient
product is an fp32 product rounded once to the operand's dtype.

While a count of the card's work is active (``kernels.ops.PLAIN_HOOKS``,
the dry run's ``launch.roofline.CostCounter``) the product is the card's
own, so the count holds no fp32 copy the card never makes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as _ops

_HALF = (torch.bfloat16, torch.float16)


def _on_fp32(*operands: torch.Tensor) -> bool:
    return (operands[0].dtype in _HALF
            and all(t.device.type == "cpu" for t in operands)
            and not _ops.PLAIN_HOOKS)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; on the CPU in half dtypes, the fp32 product rounded once."""
    if not _on_fp32(a, b):
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """``torch.einsum(equation, a, b)``; on the CPU in half dtypes, the
    fp32 contraction rounded once."""
    if not _on_fp32(a, b):
        return torch.einsum(equation, a, b)
    return torch.einsum(equation, a.float(), b.float()).to(a.dtype)
