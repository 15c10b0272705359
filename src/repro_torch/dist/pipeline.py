"""GPipe-style pipeline parallelism over a mesh axis folded onto one GPU
(port of ``repro/dist/pipeline.py``).

``pipeline_apply`` runs a stage function over ``n_stages`` stacked
parameter slices with microbatches streamed through a ring: stage ``s``
executes microbatch ``t - s`` at tick ``t``, so the pipe drains in
``n_micro + n_stages - 1`` ticks.  On one GPU the stage axis is an
explicit loop: at each tick every stage runs (the bubbles on the zero
inputs the reference feeds them), and the ring hands each stage's output
to the next.  The last stage's valid outputs are selected by index, so
nothing a bubble computes (a NaN, a -0.0) reaches the result.
``serial_reference`` is the numerics oracle (the same stages, no ring):
with a stage that runs microbatch by microbatch the two are equal bit for
bit.

This is the *LM-path* pipeline.  Its chip-level counterpart is
``repro_torch.sim.fabric.ChipPipeline``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist.sharding import Mesh, tree_leaves, tree_map


def _stage_params(params, s: int):
    return tree_map(lambda a: a[s], params)


def serial_reference(stage: Callable, params, x: torch.Tensor
                     ) -> torch.Tensor:
    """Apply the ``n_stages`` stacked stages sequentially to all
    microbatches.  x: (n_micro, mb, ...)."""
    n_stages = tree_leaves(params)[0].shape[0]
    h = x
    for s in range(n_stages):
        h = stage(_stage_params(params, s), h)
    return h


def pipeline_apply(stage: Callable, params, x: torch.Tensor, *, mesh: Mesh,
                   axis_name: str) -> torch.Tensor:
    """Pipeline ``stage`` over ``axis_name``: ``params``' leaves carry the
    stage axis first (one slice per stage), ``x`` (n_micro, mb, ...) holds
    the microbatches, the result the last stage's outputs in ``x``'s
    dtype."""
    n_stages = mesh.shape[axis_name]
    n_micro = x.shape[0]
    if tree_leaves(params)[0].shape[0] != n_stages:
        raise ValueError(f"params hold {tree_leaves(params)[0].shape[0]} "
                         f"stages for {n_stages} on {axis_name!r}")
    p = [_stage_params(params, s) for s in range(n_stages)]
    zero = torch.zeros_like(x[0])
    recv = [zero] * n_stages
    outputs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        feed = x[t] if t < n_micro else zero
        out = [stage(p[s], feed if s == 0 else recv[s])
               for s in range(n_stages)]
        # the last stage holds microbatch t - (n_stages - 1) at this tick
        mb = t - (n_stages - 1)
        if 0 <= mb < n_micro:
            outputs[mb] = out[-1].to(x.dtype)
        recv = [out[(s - 1) % n_stages] for s in range(n_stages)]
    return torch.stack(outputs)
