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

The meshed forms (``param_shardings=``, ``Trainer(mesh=, rules=)``) wait
for the port's ``dist/`` (ROADMAP Queue 1 step 5.4) and raise.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist.sharding import tree_leaves, tree_map
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.faults import (FaultInjector, StepTimer,
                                        StragglerWatchdog)

log = logging.getLogger("repro_torch.train")

MESH_NOT_PORTED = ("meshed training waits for the port's dist/ (ROADMAP "
                   "Queue 1 step 5.4)")


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


def _like(tree: Any, leaves) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(model: Model, opt: Optimizer, param_shardings=None,
                    grad_accum: int = 1):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``metrics`` holds 0-d device tensors: ``loss``, ``ce``,
    ``aux`` and ``grad_norm`` (the square root of the gradients' summed
    squares).

    ``grad_accum`` > 1 splits the batch into microbatches that interleave
    rows (B -> (B/k, k) -> k microbatches of rows i, i + k, ...), as the
    reference slices them; their gradients and losses are summed in order
    and divided by k."""
    if param_shardings is not None:
        raise NotImplementedError(MESH_NOT_PORTED)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            loss, metrics = model.loss_fn(_like(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _like(params, grads))

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
    """The training loop on one device (``cuda`` unless the caller asks
    for the CPU; raises without a card)."""

    def __init__(self, cfg: ModelConfig, opt: Optimizer, *,
                 mesh=None, rules: dict | None = None,
                 ckpt_dir: str | None = None,
                 ckpt_every: int = 50,
                 keep_last: int = 3,
                 fault_injector: FaultInjector | None = None,
                 seed: int = 0,
                 device: str | torch.device = "cuda"):
        if mesh is not None or rules is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.opt = opt
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.faults = fault_injector or FaultInjector()
        self.watchdog = StragglerWatchdog()
        self.seed = seed
        self._step = make_train_step(self.model, opt)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        gen = torch.Generator(self.device).manual_seed(self.seed)
        params = self.model.init(gen)
        return TrainState(params, self.opt.init(params), 0)

    def restore_or_init(self) -> TrainState:
        if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
            abs_params = self.model.abstract_params()
            tree = {"params": abs_params, "opt": self.opt.init(abs_params)}
            restored, step, _ = ckpt.restore(self.ckpt_dir, tree,
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
