"""Optimizers: AdamW, momentum SGD, and the paper's pulse-quantized SGD
(port of ``repro/optim/optimizers.py``).

The reference's functional API, so a test can hand both sides the same
arrays::

  opt = adamw(lr=...); state = opt.init(params)
  params, state = opt.update(grads, state, params, step=...)

Parameters, gradients and states are trees of tensors (dicts and tuples,
``dist.sharding.tree_map``'s trees).  ``update`` writes the parameters
and the state in place and returns the same trees: the port's form of the
reference's donated buffers.  It runs under ``torch.no_grad``.  Each
update is the reference's expression, one float32 operation at a time in
its order; ``lr`` is a float or a schedule of the integer step, and
adamw's bias corrections are float32 values, as the reference's jitted
step computes them at an int32 step (``_bias_correction``).

The values that change from step to step (the learning rate, adamw's bias
corrections) are computed on the host, ``opt.scalars(step)``, and enter
the update as 0-d float64 tensors on the leaves' device (``scalars=``; by
default made from ``opt.scalars(step)`` at each call), so a captured step
(``runtime.train_loop.TrainStep``) reads them from buffers that each
replay refills.  An operation with such a tensor computes what it
computes with the Python float on the CPU (a bf16 or fp16 leaf through
fp32, rounded once, as a Python scalar is applied), and the same on the
card, where a Python float divisor would become a reciprocal multiply.

``pulse_sgd`` is the paper's training circuit as an optimizer (C5): the
update is discretized into unit pulses (``core.quantization.
pulse_discretize``), and conductance-pair leaves (a path holding
``g_plus`` or ``g_minus``) are clipped to [0, w_max] after every step.
Stochastic pulse rounding takes a ``torch.Generator`` where the reference
takes a key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import quantization as q
from repro_torch.dist.sharding import tree_map


def _no_scalars(step: int) -> dict[str, float]:
    return {}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    name: str = "opt"
    scalars: Callable[[int], dict[str, float]] = _no_scalars


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def _lr_at(lr, step: int) -> float:
    return lr(step) if callable(lr) else lr


_HALF = (torch.bfloat16, torch.float16)


def device_scalars(host: dict[str, float], device: torch.device
                   ) -> dict[str, torch.Tensor]:
    """The host scalars of a step as 0-d float64 tensors on ``device``."""
    return {k: torch.tensor(v, dtype=torch.float64, device=device)
            for k, v in host.items()}


def _scaled(op, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``op(x, s)`` for a 0-d float64 tensor ``s``, as ``op`` applies a
    Python float to ``x``: in x's dtype, a half ``x`` through fp32 and
    rounded once."""
    if x.dtype in _HALF:
        return op(x.float(), s).to(x.dtype)
    return op(x, s)


def _step_scalars(opt_scalars, scalars, step: int, like) -> dict:
    if scalars is not None:
        return scalars
    return device_scalars(opt_scalars(step), like.device)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


def sgd(lr: float | Callable[[int], float], momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _tree_zeros(params)} if momentum else {}

    def host_scalars(step: int) -> dict[str, float]:
        return {"lr": _lr_at(lr, step)}

    @torch.no_grad()
    def update(grads, state, params, step: int = 0, scalars=None):
        lr_t = _step_scalars(host_scalars, scalars, step,
                             _first_leaf(params))["lr"]
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mu = tree_map(lambda m, g: m.mul_(momentum).add_(g),
                          state["mu"], grads)
            tree_map(lambda p, m: p.sub_(_scaled(torch.mul, m, lr_t)),
                     params, mu)
            return params, {"mu": mu}
        tree_map(lambda p, g: p.sub_(_scaled(torch.mul, g, lr_t)), params,
                 grads)
        return params, state

    return Optimizer(init, update, "sgd", host_scalars)


def _bias_correction(b: float, t: int) -> float:
    """``1 - b ** t`` as the reference's jitted step takes it at an int32
    step, in float32: the float64 power of float32 ``b`` rounded once to
    float32, subtracted from 1 in float32.  At b = 0.9 and 0.95 this equals
    the jitted reference bit for bit over steps 1-5000 (torch's fp32 pow
    misses one step of each).  Returned as the Python float of that
    float32 value."""
    b32 = float(torch.tensor(b, dtype=torch.float32))
    power = torch.tensor(math.pow(b32, t), dtype=torch.float32)
    return float(1 - power)


def adamw(lr: float | Callable[[int], float], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def host_scalars(step: int) -> dict[str, float]:
        t = step + 1
        return {"lr": _lr_at(lr, step), "bc1": _bias_correction(b1, t),
                "bc2": _bias_correction(b2, t)}

    @torch.no_grad()
    def update(grads, state, params, step: int = 0, scalars=None):
        s = _step_scalars(host_scalars, scalars, step, _first_leaf(params))
        m = tree_map(lambda m_, g: m_.mul_(b1).add_((1 - b1) * g),
                     state["m"], grads)
        v = tree_map(lambda v_, g: v_.mul_(b2).add_((1 - b2) * g * g),
                     state["v"], grads)

        def upd(p, m_, v_):
            u = _scaled(torch.div, m_, s["bc1"]) / (
                torch.sqrt(_scaled(torch.div, v_, s["bc2"])) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return p.sub_(_scaled(torch.mul, u, s["lr"]))

        tree_map(upd, params, m, v)
        return params, {"m": m, "v": v}

    return Optimizer(init, update, "adamw", host_scalars)


def _map_with_path(fn, tree, *rest, path: tuple = ()):
    """``tree_map`` that also hands ``fn`` each leaf's path of keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, *(r[i] for r in rest),
                                         path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def pulse_sgd(lr: float | Callable[[int], float], *, max_update: float = 0.05,
              levels: int = 128, w_max: float = 4.0) -> Optimizer:
    """Paper C5: pulse-discretized update + conductance clipping.

    Conductance-pair leaves (paths containing ``g_plus``/``g_minus``) are
    clipped to [0, w_max] after the update; other leaves get the same
    discretized-SGD treatment without clipping.
    """
    def init(params):
        return {}

    def host_scalars(step: int) -> dict[str, float]:
        return {"lr": _lr_at(lr, step)}

    @torch.no_grad()
    def update(grads, state, params, step: int = 0,
               generator: torch.Generator | None = None, scalars=None):
        neg_lr = -_step_scalars(host_scalars, scalars, step,
                                _first_leaf(params))["lr"]

        def upd(path, p, g):
            p.add_(q.pulse_discretize(_scaled(torch.mul, g, neg_lr),
                                      max_update, levels, generator))
            if any(k in ("g_plus", "g_minus") for k in path):
                p.clamp_(0.0, w_max)
            return p

        return _map_with_path(upd, params, grads), state

    return Optimizer(init, update, "pulse_sgd", host_scalars)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "pulse_sgd": pulse_sgd}[name](lr, **kw)
