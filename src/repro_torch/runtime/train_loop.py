"""Training loop: the train step, checkpoint/restart, watchdog (port of
``repro/runtime/train_loop.py``, single device).

``make_train_step`` differentiates ``model.loss_fn`` with autograd
(``grad_accum`` microbatches, the reference's interleaved slicing, summed
in order) and applies the optimizer, which writes the parameters and its
state in place (the port's form of the reference's donated buffers).
``Trainer`` is the loop: parameters from a seeded ``torch.Generator`` on
its device, periodic atomic checkpoints, ``run()`` resuming from LATEST,
the step-keyed data stream (a restart replays it exactly), one host read
of the step's metrics, and the straggler watchdog and fault-injector
hooks (``runtime/faults.py``).

The meshed forms take the reference's mesh folded onto one device
(``dist.sharding.Mesh``): ``make_train_step(param_shardings=)`` pins each
gradient to its sharding's device (an identity there), and
``Trainer(mesh=, rules=)`` builds the reference's ``rules``,
``param_shardings``, ``opt_shardings`` and ``batch_sharding``, runs on
the mesh's device, and restores checkpoints onto the shardings.  A meshed
step computes what the unmeshed one computes, bit for bit.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import value_and_grad
from repro_torch.dist.sharding import tree_leaves, tree_map
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.faults import (FaultInjector, StepTimer,
                                        StragglerWatchdog)

log = logging.getLogger("repro_torch.train")

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def make_paper_train_step(spec, lr: float, *, use_kernel: bool = True):
    """The stochastic-BP step of the paper-application path:
    ``step(stacked, batch) -> (stacked, err)`` over
    :func:`repro_torch.core.crossbar.paper_backprop_step_scan` with
    ``batch = {"x": ..., "target": ...}`` and ``stacked`` from
    ``crossbar.stack_layers``.  The conductance stacks are updated in
    place (the reference donates them): keep using the returned
    ``stacked``."""
    from repro_torch.core import crossbar as xb

    def step(stacked, batch):
        return xb.paper_backprop_step_scan(stacked, batch["x"],
                                           batch["target"], spec, lr,
                                           use_kernel)
    return step


def make_train_step(model: Model, opt: Optimizer, param_shardings=None,
                    grad_accum: int = 1):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``metrics`` holds 0-d device tensors: ``loss``, ``ce``,
    ``aux`` and ``grad_norm`` (the square root of the gradients' summed
    squares).

    ``grad_accum`` > 1 splits the batch into microbatches that interleave
    rows (B -> (B/k, k) -> k microbatches of rows i, i + k, ...), as the
    reference slices them; their gradients and losses are summed in order
    and divided by k.

    ``param_shardings`` (a ``NamedSharding`` tree) pins the gradients to
    their shardings, as the reference's constraint does: on one device
    each gradient on its sharding's device, where it already lies."""
    def constrain_grads(grads):
        if param_shardings is None:
            return grads
        return tree_map(lambda g, sh: g.to(sh.device), grads,
                        param_shardings)

    def grad_fn(params, batch):
        loss, metrics, grads = value_and_grad(model.loss_fn, params, batch)
        return loss, metrics, constrain_grads(grads)

    def micro(leaf, i):
        if leaf.dim() == 0:
            return leaf
        B = leaf.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} does not split into {grad_accum} "
                             f"microbatches")
        return leaf.reshape((B // grad_accum, grad_accum)
                            + tuple(leaf.shape[1:]))[:, i]

    def train_step(params, opt_state, batch, step: int):
        if grad_accum > 1:
            grads, loss = None, None
            for i in range(grad_accum):
                mb = tree_map(lambda leaf: micro(leaf, i), batch)
                l_i, _, g_i = grad_fn(params, mb)
                if grads is None:
                    grads, loss = g_i, l_i
                else:
                    grads = tree_map(torch.add, grads, g_i)
                    loss = loss + l_i
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = grad_fn(params, batch)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                               for g in tree_leaves(grads)))
        params, opt_state = opt.update(grads, opt_state, params, step=step)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)
    return train_step


class Trainer:
    """The training loop on one device: ``cuda`` unless the caller asks
    for the CPU (raises without a card), or the device of ``mesh``, a
    ``dist.sharding.Mesh`` folded onto one device.  With a mesh it builds
    the reference's ``rules`` (``make_rules(mesh)`` unless given),
    ``param_shardings``, ``opt_shardings`` (each state leaf the sharding
    of the parameter of its shape and dtype) and ``batch_sharding``; every
    leaf lies on the mesh's device."""

    def __init__(self, cfg: ModelConfig, opt: Optimizer, *,
                 mesh: shd.Mesh | None = None, rules: dict | None = None,
                 ckpt_dir: str | None = None,
                 ckpt_every: int = 50,
                 keep_last: int = 3,
                 fault_injector: FaultInjector | None = None,
                 seed: int = 0,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device or "cuda")
        self.model = build_model(cfg, self.device)
        self.opt = opt
        self.mesh = mesh
        self.rules = rules or (shd.make_rules(mesh) if mesh is not None
                               else None)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.faults = fault_injector or FaultInjector()
        self.watchdog = StragglerWatchdog()
        self.seed = seed
        self._build()

    def _build(self) -> None:
        model, opt = self.model, self.opt
        self._step = make_train_step(model, opt)
        if self.mesh is None:
            self.param_shardings = None
            self.opt_shardings = None
            self.batch_sharding = None
            return
        self.param_shardings = shd.named_shardings(model.spec, self.rules,
                                                   self.mesh)
        # optimizer state mirrors the parameters' shardings leaf by leaf
        abs_params = model.abstract_params()
        self.opt_shardings = _mirror_shardings(
            opt.init(abs_params), abs_params, self.param_shardings)
        self.batch_sharding = shd.NamedSharding(
            self.mesh, shd.PartitionSpec(self.rules.get("batch")))

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        gen = torch.Generator(self.device).manual_seed(self.seed)
        params = self.model.init(gen)
        return TrainState(params, self.opt.init(params), 0)

    def restore_or_init(self) -> TrainState:
        if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
            abs_params = self.model.abstract_params()
            tree = {"params": abs_params, "opt": self.opt.init(abs_params)}
            shards = ({"params": self.param_shardings,
                       "opt": self.opt_shardings}
                      if self.param_shardings is not None else None)
            restored, step, _ = ckpt.restore(self.ckpt_dir, tree,
                                             shardings=shards,
                                             device=self.device)
            log.info("restored checkpoint at step %d", step)
            return TrainState(restored["params"], restored["opt"], step)
        return self.init_state()

    def save(self, state: TrainState) -> None:
        if not self.ckpt_dir:
            return
        ckpt.save(self.ckpt_dir, state.step,
                  {"params": state.params, "opt": state.opt_state},
                  extra={"arch": self.cfg.name}, keep_last=self.keep_last)

    # ------------------------------------------------------------------
    def run(self, stream: TokenStream, num_steps: int,
            batch_fn: Callable[[int], dict] | None = None,
            log_every: int = 10) -> tuple[TrainState, list[dict]]:
        """Train for ``num_steps`` from the latest checkpoint (or scratch).

        ``batch_fn`` overrides the stream (for non-token batches).
        Returns (state, metrics history); each step's metrics are read
        from the device once."""
        state = self.restore_or_init()
        history: list[dict] = []
        while state.step < num_steps:
            self.faults.check(state.step)
            batch = (batch_fn(state.step) if batch_fn is not None
                     else stream.batch_at(state.step))
            batch = tree_map(lambda a: a.to(self.device), batch)
            with StepTimer(self.device) as t:
                params, opt_state, metrics = self._step(
                    state.params, state.opt_state, batch, state.step)
                names = sorted(metrics)
                metrics = dict(zip(names, torch.stack(
                    [metrics[k].float() for k in names]).tolist()))
            state = TrainState(params, opt_state, state.step + 1)
            straggled = self.watchdog.observe(state.step, t.dt)
            metrics.update(step=state.step, time_s=t.dt,
                           straggler=bool(straggled))
            history.append(metrics)
            if state.step % log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", state.step,
                         metrics["loss"], t.dt)
            if self.ckpt_every and state.step % self.ckpt_every == 0:
                self.save(state)
        return state, history


def _mirror_shardings(abs_opt, abs_params, param_shardings):
    """Give optimizer-state leaves the sharding of the first parameter (in
    the reference's sorted-key order) with the same shape and dtype;
    replicate otherwise."""
    flat_p = dict(ckpt._walk(abs_params))
    flat_s = dict(ckpt._walk(param_shardings))
    by_shape: dict[tuple, Any] = {}
    for path in sorted(flat_p):
        p = flat_p[path]
        by_shape.setdefault((tuple(p.shape), p.dtype), flat_s[path])
    mesh = next(iter(flat_s.values())).mesh

    def pick(leaf):
        return by_shape.get((tuple(leaf.shape), leaf.dtype),
                            shd.NamedSharding(mesh, shd.PartitionSpec()))

    return tree_map(pick, abs_opt)

