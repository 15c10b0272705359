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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    name: str = "opt"


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def _lr_at(lr, step: int) -> float:
    return lr(step) if callable(lr) else lr


def sgd(lr: float | Callable[[int], float], momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _tree_zeros(params)} if momentum else {}

    @torch.no_grad()
    def update(grads, state, params, step: int = 0):
        lr_t = _lr_at(lr, step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum:
            mu = tree_map(lambda m, g: m.mul_(momentum).add_(g),
                          state["mu"], grads)
            tree_map(lambda p, m: p.sub_(lr_t * m), params, mu)
            return params, {"mu": mu}
        tree_map(lambda p, g: p.sub_(lr_t * g), params, grads)
        return params, state

    return Optimizer(init, update, "sgd")


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

    @torch.no_grad()
    def update(grads, state, params, step: int = 0):
        lr_t = _lr_at(lr, step)
        t = step + 1
        m = tree_map(lambda m_, g: m_.mul_(b1).add_((1 - b1) * g),
                     state["m"], grads)
        v = tree_map(lambda v_, g: v_.mul_(b2).add_((1 - b2) * g * g),
                     state["v"], grads)
        bc1 = _bias_correction(b1, t)
        bc2 = _bias_correction(b2, t)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return p.sub_(lr_t * u)

        tree_map(upd, params, m, v)
        return params, {"m": m, "v": v}

    return Optimizer(init, update, "adamw")


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

    @torch.no_grad()
    def update(grads, state, params, step: int = 0,
               generator: torch.Generator | None = None):
        lr_t = _lr_at(lr, step)

        def upd(path, p, g):
            p.add_(q.pulse_discretize(-lr_t * g, max_update, levels,
                                      generator))
            if any(k in ("g_plus", "g_minus") for k in path):
                p.clamp_(0.0, w_max)
            return p

        return _map_with_path(upd, params, grads), state

    return Optimizer(init, update, "pulse_sgd")


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "pulse_sgd": pulse_sgd}[name](lr, **kw)
