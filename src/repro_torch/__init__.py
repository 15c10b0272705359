"""repro_torch: the PyTorch/CUDA port of the crossbar training architecture.

A second package beside the JAX reference ``repro``, laid out module for
module like it so each port file has one counterpart to be held against.
It imports ``torch`` only — never ``jax`` and nothing of ``repro`` — and
its entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Each Pallas kernel of the reference becomes a kernel
written by hand for Hopper (``repro_torch/kernels``); on CPU tensors the
wrappers run the kernel's plain PyTorch version instead.
"""
from __future__ import annotations


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raises for a CUDA device when no
    card is present, so nothing silently runs on the CPU."""
    import torch   # not at import time: docs tooling finds modules without it

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run its plain CPU versions")
    return device
