"""Whole-step CUDA graphs: the port's form of ``jax.jit`` with donated
buffers.

A step whose body reads its inputs from fixed tensors and writes its
state in place runs on the card as one captured ``torch.cuda.CUDAGraph``:
the body runs once under capture and every later call replays it, so the
host enqueues one graph launch instead of every operation.  :class:`Graph`
keeps the rules that every captured step of the port follows (the virtual
chip's programs in ``sim.compiled`` and the LM server's decode step in
``runtime.serve_loop``):

  * the first call is the warm-up (:meth:`Graph.warm_up`): the body runs
    for real on a side stream, and that call returns its own result (a
    training step is applied once, a decode step appends its token once);
    the capture (:meth:`Graph.capture`) follows in the same call and
    executes nothing;
  * a capture that fails raises; nothing falls back to running the body
    eagerly;
  * the kernel wrappers' ``launches`` tick under capture without anything
    running, so a capture records each wrapper's ticks, takes them back
    and adds them on every replay: ``launches`` counts launches executed.

A replay's result is the graph's own output memory, which the next replay
overwrites: a caller that keeps it clones it (:func:`clone_tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels import ops as _wrappers


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's ``launches``, read from the ops module itself
    (not through a name a caller may have wrapped to record calls)."""
    return {name: fn.launches for name, fn in vars(_wrappers).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}


def clone_tree(tree: Any) -> Any:
    """Copy the tensors of a (nested) result out of a graph's memory."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(t) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


class Graph:
    """``body`` captured as one CUDA graph on ``device`` (a CUDA device).

    :meth:`warm_up` runs the body on a side stream and returns that run's
    result; :meth:`capture` then captures the body; :meth:`replay` runs
    the capture and returns its output tensors.  The body must read every
    input from tensors whose addresses stay fixed from the capture on."""

    def __init__(self, body: Callable, device: torch.device):
        self.body = body
        self.device = device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.result: Any = None
        self.per_replay: dict[str, int] = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def warm_up(self, *inputs):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.body(*inputs)
        current.wait_stream(side)
        return result

    def capture(self, *inputs) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.result = self.body(*inputs)
        after = launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        for name, n in before.items():      # a capture launches nothing
            getattr(_wrappers, name).launches = n
        self.graph = graph

    def replay(self):
        self.graph.replay()
        for name, n in self.per_replay.items():
            getattr(_wrappers, name).launches += n
        return self.result

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds in this graph's private pool
        (None before the capture)."""
        if self.graph is None:
            return None
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
