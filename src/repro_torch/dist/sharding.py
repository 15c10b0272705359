"""Parameter specs and their initialisation on one device (port of the
single-device part of ``repro/dist/sharding.py``).

Parameters are declared as :class:`ParamSpec` leaves (shape, logical axes,
initializer) in a tree of dicts and tuples with the reference's keys.  The
logical axes are kept so the trees compare leaf for leaf; on one GPU no
rule reads them.  ``shard_activation`` and ``constrain_like_specs`` are
identities on one device and are not ported; the mesh rules wait for the
``dist/`` slice (ROADMAP Queue 1 item 10).

An initializer is ``init(generator, shape, dtype, device) -> Tensor``: it
draws from an explicit ``torch.Generator`` on the target device.  The
streams differ from ``jax.random``'s, so the parity tests carry the
reference's parameters across (``repro_torch.interop``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Init = Callable[[torch.Generator, tuple[int, ...], torch.dtype,
                 torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape + logical axis names + initializer.

    A leading ``"layers"`` logical axis marks a stacked parameter (one
    slice per period); ``init_params`` draws each slice independently.
    """
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    init: Init
    dtype: torch.dtype = torch.float32


def zeros_init() -> Init:
    return lambda gen, shape, dtype, device: torch.zeros(
        shape, dtype=dtype, device=device)


def ones_init() -> Init:
    return lambda gen, shape, dtype, device: torch.ones(
        shape, dtype=dtype, device=device)


def normal_init(std: float) -> Init:
    return lambda gen, shape, dtype, device: torch.randn(
        shape, generator=gen, dtype=dtype, device=device) * std


def fanin_init(axis: int) -> Init:
    """Normal(0, 1/fan_in) with fan_in read from ``shape[axis]``."""
    def init(gen, shape, dtype, device):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * shape[axis] ** -0.5
    return init


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of a tree of dicts, tuples and lists
    (and to the matching leaves of ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of a tree in ``tree_map``'s order."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out


def stack_specs(tree, n: int):
    """Stack a spec tree ``n`` times along a new leading "layers" axis."""
    return tree_map(lambda s: ParamSpec((n,) + tuple(s.shape),
                                        ("layers",) + tuple(s.logical_axes),
                                        s.init, s.dtype), tree)


def param_count(tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def _init_leaf(gen: torch.Generator, s: ParamSpec,
               device: torch.device) -> torch.Tensor:
    if s.logical_axes and s.logical_axes[0] == "layers":
        # stacked layers draw independently, slice by slice
        sub = ParamSpec(tuple(s.shape[1:]), tuple(s.logical_axes[1:]),
                        s.init, s.dtype)
        out = torch.empty(s.shape, dtype=s.dtype, device=device)
        for i in range(s.shape[0]):
            out[i] = _init_leaf(gen, sub, device)
        return out
    return s.init(gen, tuple(s.shape), s.dtype, device)


def init_params(generator: torch.Generator, tree):
    """Concrete parameters for a ParamSpec tree, drawn leaf by leaf from
    ``generator`` on its device."""
    device = generator.device
    return tree_map(lambda s: _init_leaf(generator, s, device), tree)


def cast_for_compute(params, dtype: torch.dtype):
    """Cast float leaves to the compute dtype (params stay fp32 at rest)."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)
