"""Logical-axis sharding on one GPU: ParamSpec trees, the mesh rules, and
activation constraints (port of ``repro/dist/sharding.py``).

Parameters are declared as :class:`ParamSpec` leaves (shape, logical axes,
initializer) in a tree of dicts and tuples with the reference's keys.
Every physical decision is deferred to a *rules* dict mapping logical axis
names ("fsdp", "heads", "batch", ...) to mesh axes; ``logical_to_pspec``
applies them with the reference's divisibility fallback, so the port's
``PartitionSpec`` trees equal the reference's for every mesh shape.

A :class:`Mesh` here is the reference's mesh folded onto one device: its
named axes keep their sizes (the specs are computed from them) and every
axis lies on the mesh's one ``torch.device``, as the chip farm folds its
chips into an array axis.  A :class:`NamedSharding` therefore places a
tensor on that device and nothing more; where an axis must be computed
over (the data-parallel step, the pipeline) the code that needs it
carries it as an explicit array axis (``dist.collectives``,
``dist.pipeline``).  ``torch.distributed`` is not used.

``activation_sharding`` keeps the reference's context stack;
``shard_activation`` and ``constrain_like_specs`` place their argument on
the context's device (identities for tensors already there) and are
identities outside a context.  The layers do not call them: on one device
they change nothing.

An initializer is ``init(generator, shape, dtype, device) -> Tensor``: it
draws from an explicit ``torch.Generator`` on the target device.  The
streams differ from ``jax.random``'s, so the parity tests carry the
reference's parameters across (``repro_torch.interop``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Sequence

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


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in ``tree_map``'s
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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


def abstract_params(tree):
    """A ParamSpec tree as ``meta`` tensors: shapes and dtypes, nothing
    allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


# ---------------------------------------------------------------------------
# Meshes, partition specs and shardings on one device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of given sizes, all folded onto one ``device``."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes", tuple(self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "device", torch.device(self.device))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (jax's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class PartitionSpec:
    """jax's ``P``: one entry per leading dim, each None (replicated), a
    mesh axis name or a tuple of names.  A tree leaf that iterates, indexes
    and compares as the tuple of its entries."""
    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._parts
        if not isinstance(other, tuple):
            return NotImplemented
        return self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh; on one device it places a tensor on the mesh's
    device."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.device


# ---------------------------------------------------------------------------
# Logical -> physical rules
# ---------------------------------------------------------------------------

def make_rules(mesh: Mesh, overrides: dict | None = None) -> dict:
    """Default logical->physical mapping for a mesh, plus per-arch overrides.

    Data-like axes ("pod", "data") carry the batch and FSDP; the "model"
    axis carries tensor parallelism (heads/ff/vocab/experts).  Axes absent
    from the mesh fall away (their logical names map to None = replicated).
    """
    names = set(mesh.axis_names)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    model_ax = "model" if "model" in names else None
    batch: Any = None
    if data_axes:
        batch = data_axes if len(data_axes) > 1 else data_axes[0]
    rules = {
        "batch": batch,
        "fsdp": "data" if "data" in names else None,
        "model": model_ax,
        "heads": model_ax,
        "ff": model_ax,
        "vocab": model_ax,
        "experts": model_ax,
        "layers": None,
        "seq": None,
        "act_embed": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def _axis_size(mesh: Mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def logical_to_pspec(logical_axes: Sequence[str | None], rules: dict,
                     mesh: Mesh, shape: Sequence[int]) -> PartitionSpec:
    """Apply rules with the divisibility fallback.

    Each dim gets its assigned mesh axes only if the dim size divides the
    product of their sizes; composite assignments (e.g. batch over
    ("pod", "data")) drop to the longest divisible prefix.  A mesh axis is
    used at most once per spec (earlier dims win).
    """
    used: set[str] = set()
    entries: list[Any] = []
    for dim, ln in zip(shape, logical_axes):
        phys = rules.get(ln) if ln is not None else None
        if phys is None:
            entries.append(None)
            continue
        axes = phys if isinstance(phys, tuple) else (phys,)
        axes = tuple(a for a in axes if a is not None and a not in used)
        # longest divisible prefix
        while axes and (dim % _axis_size(mesh, axes) != 0):
            axes = axes[:-1]
        if not axes:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes if len(axes) > 1 else axes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def partition_specs(tree, rules: dict, mesh: Mesh):
    """ParamSpec tree -> PartitionSpec tree."""
    return tree_map(
        lambda s: logical_to_pspec(s.logical_axes, rules, mesh, s.shape),
        tree)


def named_shardings(tree, rules: dict, mesh: Mesh):
    """ParamSpec tree -> NamedSharding tree."""
    return tree_map(lambda p: NamedSharding(mesh, p),
                    partition_specs(tree, rules, mesh))


# ---------------------------------------------------------------------------
# Activation sharding context
# ---------------------------------------------------------------------------

_ACT_CTX: list[tuple[Mesh, dict]] = []


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, rules: dict):
    """While active, ``shard_activation`` / ``constrain_like_specs`` place
    their argument on the mesh's device; outside they are identities."""
    _ACT_CTX.append((mesh, rules))
    try:
        yield
    finally:
        _ACT_CTX.pop()


def _current_ctx():
    return _ACT_CTX[-1] if _ACT_CTX else None


def shard_activation(x: torch.Tensor, *logical_axes: str | None
                     ) -> torch.Tensor:
    """``x`` constrained to the spec its logical axes imply: on one device,
    ``x`` on the context's device (``x`` itself where it lies there)."""
    ctx = _current_ctx()
    if ctx is None:
        return x
    return x.to(ctx[0].device)


def constrain_like_specs(params, spec_tree):
    """Pin a params tree to the shardings its ParamSpec tree implies: on
    one device, each leaf on the context's device.  No-op outside an
    ``activation_sharding`` context."""
    ctx = _current_ctx()
    if ctx is None:
        return params
    device = ctx[0].device
    return tree_map(lambda s, p: p.to(device), spec_tree, params)

