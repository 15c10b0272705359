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

On the card the steps are captured CUDA graphs (``graphs.Graph``), the
port's form of the reference's ``jax.jit(step_fn, donate_argnums=(0,
1))`` and jitted, donating ``paper_backprop_step_scan``: the
``Trainer``'s step is a :class:`TrainStep`, and ``make_paper_train_step``
returns a :class:`PaperTrainStep`.  On the CPU both call the eager step.

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

from repro_torch import graphs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import value_and_grad
from repro_torch.dist.sharding import tree_leaves, tree_map
from repro_torch.layers import moe
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import Optimizer, device_scalars
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.faults import (FaultInjector, StepTimer,
                                        StragglerWatchdog)

log = logging.getLogger("repro_torch.train")

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def make_paper_train_step(spec, lr: float, *, use_kernel: bool = True
                          ) -> "PaperTrainStep":
    """The stochastic-BP step of the paper-application path:
    ``step(stacked, batch) -> (stacked, err)`` over
    :func:`repro_torch.core.crossbar.paper_backprop_step_scan` with
    ``batch = {"x": ..., "target": ...}`` and ``stacked`` from
    ``crossbar.stack_layers``.  The conductance stacks are updated in
    place (the reference donates them): keep using the returned
    ``stacked``.  On the card the step is captured
    (:class:`PaperTrainStep`)."""
    return PaperTrainStep(spec, lr, use_kernel=use_kernel)


class PaperTrainStep:
    """``paper_backprop_step_scan`` at one (spec, lr, use_kernel), called as
    ``step(stacked, batch) -> (stacked, err)``.

    On the card each (stacks, batch shapes and dtypes) runs as one
    captured CUDA graph: its first call runs the step on a side stream
    (that call's own result) and captures it; every later call copies
    ``x`` and ``target`` into the capture's static buffers and replays,
    updating the captured stacks in place.  ``err`` is then the graph's
    output buffer, which the next replay overwrites: clone it to keep it.
    Another stacked dict (new tensors) captures again in place of the
    graph of its shapes; ``captures`` counts every capture.  A failed
    capture raises; nothing falls back to the eager step.  On the CPU the
    step calls ``paper_backprop_step_scan`` directly."""

    def __init__(self, spec, lr: float, *, use_kernel: bool = True):
        self.spec, self.lr, self.use_kernel = spec, lr, use_kernel
        self.compiled: bool | None = None   # None: on CUDA operands
        self.captures = 0
        self.graphs: dict[tuple, tuple] = {}

    def eager(self, stacked, batch):
        from repro_torch.core import crossbar as xb
        return xb.paper_backprop_step_scan(stacked, batch["x"],
                                           batch["target"], self.spec,
                                           self.lr, self.use_kernel)

    def __call__(self, stacked, batch):
        x = batch["x"]
        if not (x.device.type == "cuda" if self.compiled is None
                else self.compiled):
            return self.eager(stacked, batch)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(stacked.items())) + tuple(
            (k, tuple(batch[k].shape), batch[k].dtype)
            for k in ("x", "target"))
        leaves = list(stacked.values())
        feed = {k: batch[k] for k in ("x", "target")}
        held = self.graphs.pop(key, None)
        if held is not None and graphs.bind(leaves, held[2], feed, held[1]):
            self.graphs[key] = held
            _, err = held[0].replay()
            return stacked, err
        del held                        # the old capture's pool goes first
        bufs = {k: v.clone() for k, v in feed.items()}
        graph = graphs.Graph(lambda: self.eager(stacked, bufs), x.device)
        result = graph.warm_up()
        graph.capture()
        self.captures += 1
        self.graphs[key] = (graph, bufs, leaves)
        return result


def make_train_step(model: Model, opt: Optimizer, param_shardings=None,
                    grad_accum: int = 1,
                    generator: torch.Generator | None = None):
    """``train_step(params, opt_state, batch, step, scalars=None) ->
    (params, opt_state, metrics)``.  ``metrics`` holds 0-d device tensors:
    ``loss``, ``ce``, ``aux`` and ``grad_norm`` (the square root of the
    gradients' summed squares).  ``scalars`` are the optimizer's step
    scalars as 0-d device tensors (``opt.scalars(step)`` through
    ``optimizers.device_scalars``), made at each call when not given.
    ``generator`` is handed to the update (``pulse_sgd``'s stochastic
    pulse rounding); without it the update rounds to nearest.

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

    extra = {} if generator is None else {"generator": generator}

    def train_step(params, opt_state, batch, step: int, scalars=None):
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
        params, opt_state = opt.update(grads, opt_state, params, step=step,
                                       scalars=scalars, **extra)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)
    return train_step


class TrainStep:
    """The ``Trainer``'s step, called as ``make_train_step``'s function is:
    ``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``, the parameters and the optimizer state updated in place.

    On the card the step is one captured CUDA graph (``graphs.Graph``):
    the first call runs the step on a side stream (that call's own result:
    the update is applied once) and captures it; every later call copies
    the batch into the capture's static buffers and the optimizer's host
    scalars of its step (``opt.scalars(step)``: the learning rate, adamw's
    bias corrections, computed on the host as the eager step computes
    them) into 0-d float64 device buffers, and replays.  The metrics come
    back as the graph's output buffers, which the next replay overwrites.
    The ``grad_accum`` loop, remat, the flash kernel's autograd function
    and kernel mode's ``crossbar_matmul`` all run inside the one graph.  A
    failed capture raises; nothing falls back to the eager step.

    A replay needs the very parameter and optimizer-state tensors that
    were captured, and a batch of the captured keys, shapes and dtypes.
    Any other call (a restored or replaced leaf, another batch shape)
    captures again; ``captures`` counts every capture.  Where
    ``layers.moe.ROUTING`` is a list, every replay appends clones of the
    records the capture made, as ``serve_loop.DecodeStep`` does.

    ``generator`` (a CUDA generator on the card) feeds ``pulse_sgd``'s
    stochastic rounding; it is registered with each capture, so every
    replay draws what the eager step would draw.  On the CPU the step
    calls ``fn``, ``make_train_step``'s function, and never captures."""

    def __init__(self, model: Model, opt: Optimizer, *, grad_accum: int = 1,
                 generator: torch.Generator | None = None):
        self.fn = make_train_step(model, opt, grad_accum=grad_accum,
                                  generator=generator)
        self.opt = opt
        self.device = torch.device(model.device)
        self.compiled = self.device.type == "cuda"
        self.generators = () if generator is None else (generator,)
        if self.compiled and generator is not None and (
                generator.device.type != "cuda" or not hasattr(
                    torch.cuda.CUDAGraph, "register_generator_state")):
            raise ValueError(
                "a captured step draws only from a CUDA generator that its "
                "graph can register (CUDAGraph.register_generator_state)")
        self.captures = 0
        self.graph: graphs.Graph | None = None
        self._inputs: list = []
        self._batch: dict[str, torch.Tensor] = {}
        self._scalars: dict[str, torch.Tensor] = {}
        self._records: list = []

    def __call__(self, params, opt_state, batch: dict, step: int):
        if not self.compiled:
            return self.fn(params, opt_state, batch, step)
        host = self.opt.scalars(step)
        if self.graph is None or not self._bind(params, opt_state, batch,
                                                host):
            return self._capture(params, opt_state, batch, step, host)
        _, _, metrics = self.graph.replay()
        moe.replay_records(self._records)
        return params, opt_state, metrics

    def pool_bytes(self) -> int | None:
        """Bytes held in the captured graph's private memory pool."""
        return self.graph.pool_bytes() if self.graph is not None else None

    def _capture(self, params, opt_state, batch, step, host):
        self.graph = None               # the old capture's pool goes first
        bufs = {k: torch.empty_like(v, device=self.device).copy_(v)
                for k, v in batch.items()}
        scalars = device_scalars(host, self.device)
        graph = graphs.Graph(
            lambda: self.fn(params, opt_state, bufs, step, scalars=scalars),
            self.device, generators=self.generators)
        result = graph.warm_up()
        self._records = moe.capture_records(graph.capture)
        self.captures += 1
        self.graph, self._batch, self._scalars = graph, bufs, scalars
        self._inputs = tree_leaves(params) + tree_leaves(opt_state)
        return result

    def _bind(self, params, opt_state, batch, host) -> bool:
        """Copy the call's batch and host scalars into the capture's
        buffers; False where the call's tensors are not the captured
        ones."""
        if not graphs.bind(tree_leaves(params) + tree_leaves(opt_state),
                           self._inputs, batch, self._batch):
            return False
        for k, v in host.items():
            self._scalars[k].fill_(v)
        return True


class Trainer:
    """The training loop on one device: ``cuda`` unless the caller asks
    for the CPU (raises without a card), or the device of ``mesh``, a
    ``dist.sharding.Mesh`` folded onto one device.  With a mesh it builds
    the reference's ``rules`` (``make_rules(mesh)`` unless given),
    ``param_shardings``, ``opt_shardings`` (each state leaf the sharding
    of the parameter of its shape and dtype) and ``batch_sharding``; every
    leaf lies on the mesh's device.

    ``step`` is the :class:`TrainStep` (captured on the card) and
    ``train_step`` what ``run`` calls, the same object: set
    ``trainer.train_step = trainer.step.fn`` to train eagerly on the
    card."""

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
        self.step = TrainStep(model, opt)
        self.train_step = self.step
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
                params, opt_state, metrics = self.train_step(
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

