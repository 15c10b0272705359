"""Compressed gradient collectives, the data-parallel step and the chip
farm's reductions, on one GPU (port of ``repro/dist/collectives.py``).

On one GPU a mesh's devices are an array axis (``dist.sharding.Mesh``),
so there is no ``shard_map`` and no ``axis_name``: each reduction sums an
explicit leading axis that holds the per-device values.  The sums run as
an explicit ascending loop over that axis (device ``0 .. D-1``), which is
the order XLA's CPU all-reduce adds in: its order is fixed and uses no
atomics, so it is deterministic, and the farm's eager and compiled steps
reduce identically.

``compressed_grad_mean`` is the paper's narrow-transport discipline
(8-bit sign-magnitude error links, section III.F) at the data-parallel
level: "bf16" averages in bf16 as XLA's all-reduce does (the float32 sum
in device order, rounded once to bf16, then divided by D in bf16); "int8"
adds a broadcast leg re-quantized to int8 with *stochastic* rounding
(unbiased in expectation).  ``dp_train_step_fn`` wires it into a
data-parallel train step over the mesh folded onto the card.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.core import quantization as q
from repro_torch.dist.sharding import (Mesh, tree_leaves, tree_map,
                                       tree_unflatten)

INT8_MAX = 127


def _ordered_sum(stack: torch.Tensor, dtype: torch.dtype | None = None
                 ) -> torch.Tensor:
    """The sum over ``stack``'s leading axis in ascending order (each term
    cast to ``dtype`` first when given)."""
    out = stack[0] if dtype is None else stack[0].to(dtype)
    for d in range(1, stack.shape[0]):
        out = out + (stack[d] if dtype is None else stack[d].to(dtype))
    return out


def _int8_stochastic(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic int8 round-trip, E[deq(quant(x))] == x over ``noise``
    uniform in [0, 1) of ``x``'s shape (the reference draws it from a
    key)."""
    scale = torch.max(torch.abs(x)) / INT8_MAX
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.floor(x / scale + noise), -INT8_MAX, INT8_MAX)
    return codes * scale


def compressed_grad_mean(grads, mesh: Mesh, axis_names: tuple[str, ...],
                         *, mode: str = "none",
                         generator: torch.Generator | None = None,
                         noise: Any = None):
    """Mean over the devices of ``axis_names`` of per-device gradients.

    Each leaf of ``grads`` is (D, ...) with D the product of the named
    axes' sizes, device-major in mesh order; the result's leaves are
    (...), in the leaf's dtype.

    mode "none": exact all-reduce, the sum in device order / D.
    mode "bf16": each value rounded to bf16, summed in float32 in device
                 order, rounded once to bf16 and divided by D in bf16 (half
                 the bytes, deterministic rounding).
    mode "int8": the bf16 mean, then an int8 stochastically-rounded
                 broadcast leg (quarter bytes, unbiased): its uniform noise
                 drawn from ``generator`` (one draw per leaf in leaf
                 order), or taken from ``noise``, a tree of ``grads``'s
                 structure holding each leaf's noise.
    """
    axis = tuple(axis_names)
    n = math.prod(mesh.shape[a] for a in axis)
    for g in tree_leaves(grads):
        if g.dim() == 0 or g.shape[0] != n:
            raise ValueError(f"a gradient leaf of shape {tuple(g.shape)} "
                             f"has no leading axis of the {n} devices of "
                             f"{axis}")

    def bf16_mean(g):
        return (_ordered_sum(g.to(torch.bfloat16), torch.float32)
                .to(torch.bfloat16) / n)

    if mode == "none":
        return tree_map(lambda g: _ordered_sum(g) / n, grads)
    if mode == "bf16":
        return tree_map(lambda g: bf16_mean(g).to(g.dtype), grads)
    if mode != "int8":
        raise ValueError(f"unknown compression mode: {mode!r}")
    if (generator is None) == (noise is None):
        raise ValueError("int8 compression takes a generator or its noise")

    def leaf(g, u=None):
        m = bf16_mean(g).to(torch.float32)
        if u is None:
            u = torch.rand(m.shape, generator=generator,
                           dtype=torch.float32, device=m.device)
        return _int8_stochastic(m, u.to(m.device)).to(g.dtype)

    if noise is not None:
        return tree_map(leaf, grads, noise)
    return tree_map(leaf, grads)


def value_and_grad(loss_fn: Callable, params, batch):
    """``loss_fn(params, batch) -> (loss, aux)`` and the gradient of
    ``loss`` with respect to every leaf of ``params`` (zeros where it does
    not reach), by autograd on detached copies of the leaves:
    (loss, aux, grads), all detached."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, aux = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(), tree_map(lambda a: a.detach(), aux),
            tree_unflatten(params, grads))


def shard_rows(leaf: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """Device ``d``'s block of ``leaf``'s rows when its leading axis is
    split into ``n`` contiguous blocks, as ``P("data")`` splits it; a 0-d
    leaf is replicated."""
    if leaf.dim() == 0:
        return leaf
    B = leaf.shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} devices")
    return leaf[d * (B // n):(d + 1) * (B // n)]


def dp_train_step_fn(loss_fn: Callable, opt, mesh: Mesh, *,
                     compression: str = "int8") -> Callable:
    """Pure data-parallel train step with a compressed gradient mean.

    ``loss_fn(params, batch) -> (loss, aux)``; ``opt`` follows
    ``repro_torch.optim.Optimizer``.  Returns ``step(params, opt_state,
    batch, step, generator=None) -> (params, opt_state, loss)``: the batch
    is split into contiguous row blocks, one per device of the mesh in
    mesh order; each block's loss and gradient are taken in turn on the
    mesh's device; the gradients are averaged by ``compressed_grad_mean``
    over every mesh axis (``generator`` draws the int8 noise) and the
    losses as ``pmean`` averages them; the optimizer then writes the
    replicated parameters and state in place (the reference donates
    them).
    """
    axis = tuple(mesh.axis_names)
    n = mesh.size

    def step_fn(params, opt_state, batch, step: int,
                generator: torch.Generator | None = None):
        stacked, losses = None, []
        for d in range(n):
            shard = tree_map(lambda a: shard_rows(a, d, n), batch)
            loss, _, grads = value_and_grad(loss_fn, params, shard)
            grads = tree_leaves(grads)
            if stacked is None:
                stacked = [torch.empty((n,) + tuple(g.shape), dtype=g.dtype,
                                       device=g.device) for g in grads]
            for buf, g in zip(stacked, grads):
                buf[d].copy_(g)
            losses.append(loss)
            del grads
        grads = compressed_grad_mean(tree_unflatten(params, stacked), mesh,
                                     axis, mode=compression,
                                     generator=generator)
        del stacked
        loss = _ordered_sum(torch.stack(losses)) / n
        params, opt_state = opt.update(grads, opt_state, params, step=step)
        return params, opt_state, loss
    return step_fn


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
