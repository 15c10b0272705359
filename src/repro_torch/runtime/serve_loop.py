"""Batched serving loop: greedy decode with per-slot tracking (port of
``repro/runtime/serve_loop.py``).

A fixed-batch server: every slot carries its own prompt cursor and
generation state.  The decode step is the model's ``decode_fn`` on a
cache that it updates in place (the reference donates the cache to a
jitted step).  On the card it runs as :class:`DecodeStep`, one captured
CUDA graph per server, reused across steps and ``generate`` calls: the
port's form of the reference's ``jax.jit(model.decode_fn,
donate_argnums=(1,))``, one graph reused across requests (static
shapes).  On the CPU the same object calls ``decode_fn``.  The step's
length is a 0-d int32 tensor on the device, as the reference's
``jnp.int32(step)``; each step reads back to the host only the argmax
tokens, outside the graph, as the reference's ``np.asarray`` does.

:class:`RequestQueue` is the shared front-end discipline: a FIFO of
fixed-shape requests with per-slot refill and completion tracking.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from repro_torch import graphs
from repro_torch.dist.sharding import tree_leaves
from repro_torch.layers import moe
from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    tokens_out: int = 0
    requests_done: int = 0


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a fixed-shape input and its queue id."""
    rid: int
    x: Any                      # (features,) or (m, features) array


class RequestQueue:
    """FIFO request queue with completion tracking (per-slot refill).

    ``pop`` hands the next request to a free slot; ``complete`` records its
    result.  Results are retrievable in request order, so the server's
    routing never reorders the client-visible stream."""

    def __init__(self, inputs: Any | None = None):
        self._pending: collections.deque[Request] = collections.deque()
        self._results: dict[int, Any] = {}
        self._next_rid = 0
        self.submitted = 0
        self.completed = 0
        if inputs is not None:
            for x in inputs:
                self.submit(x)

    def submit(self, x: Any) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(rid, x))
        self.submitted += 1
        return rid

    def pop(self) -> Request | None:
        return self._pending.popleft() if self._pending else None

    @property
    def pending(self) -> tuple:
        """Read-only snapshot of the queued requests (arrival order)."""
        return tuple(self._pending)

    def complete(self, rid: int, result: Any) -> None:
        if rid in self._results:
            raise ValueError(f"request {rid} completed twice")
        self._results[rid] = result
        self.completed += 1

    @property
    def drained(self) -> bool:
        return not self._pending and self.completed == self.submitted

    def results(self) -> list[Any]:
        """Completed results in submission order."""
        return [self._results[r] for r in sorted(self._results)]


class DecodeStep:
    """A server's decode step, called as ``decode_fn`` is: ``step(params,
    cache, batch) -> (logits, cache)``, the cache updated in place.

    On the card the step is one captured CUDA graph (`graphs.Graph`): the
    first call runs ``decode_fn`` on a side stream (that call's own
    result) and captures it; every later call copies the batch
    (``tokens`` (B, 1) int32 and ``length``, a 0-d int32 tensor) into the
    capture's static buffers and replays it.  The logits come back as the
    graph's output buffer, which the next replay overwrites.  A failed
    capture raises; nothing falls back to eager decode.

    A replay needs the very parameter and cache tensors that were
    captured, and a batch of the captured shapes and dtypes.  Any other
    call — a cache leaf replaced since the capture (``server.cache["cross"]
    = fill_cross_cache(...)``, or a whole new cache), another parameter
    tensor, another batch shape — captures again, so the graph never reads
    a stale leaf; ``captures`` counts every capture.

    Where ``layers.moe.ROUTING`` is a list, the records the capture made
    are taken out of it and every replay appends clones of them: the list
    holds one ``Routing`` a moe layer a step, as eager decode leaves it.

    On the CPU the step calls ``decode_fn`` directly and never captures."""

    def __init__(self, decode_fn, device: torch.device):
        self.decode_fn = decode_fn
        self.device = device
        self.compiled = device.type == "cuda"
        self.captures = 0
        self.graph: graphs.Graph | None = None
        self._inputs: list = []
        self._batch: dict[str, torch.Tensor] = {}
        self._records: list = []

    def __call__(self, params: Any, cache: Any, batch: dict):
        if not self.compiled:
            return self.decode_fn(params, cache, batch)
        if self.graph is None or not self._bind(params, cache, batch):
            return self._capture(params, cache, batch)
        logits, _ = self.graph.replay()
        moe.replay_records(self._records)
        return logits, cache

    def pool_bytes(self) -> int | None:
        """Bytes held in the captured graph's private memory pool."""
        return self.graph.pool_bytes() if self.graph is not None else None

    def _capture(self, params, cache, batch):
        self.graph = None               # the old capture's pool goes first
        bufs = {k: torch.empty_like(v, device=self.device).copy_(v)
                for k, v in batch.items()}
        graph = graphs.Graph(lambda: self.decode_fn(params, cache, bufs),
                             self.device)
        result = graph.warm_up()
        self._records = moe.capture_records(graph.capture)
        self.captures += 1
        self.graph, self._batch = graph, bufs
        self._inputs = tree_leaves(params) + tree_leaves(cache)
        return result

    def _bind(self, params, cache, batch) -> bool:
        """Copy the call's batch into the capture's buffers; False where
        the call's tensors are not the captured ones."""
        return graphs.bind(tree_leaves(params) + tree_leaves(cache),
                           self._inputs, batch, self._batch)


class BatchedServer:
    """Greedy token server over a fixed decode batch, on the model's
    device.  ``decode`` is the server's :class:`DecodeStep` (captured on
    the card), which a caller may wrap to record each step, or replace
    with ``model.decode_fn`` to decode eagerly."""

    def __init__(self, model: Model, params: Any, *, batch: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache = model.init_cache(batch, max_len, cache_dtype)
        self.step = DecodeStep(model.decode_fn, model.device)
        self.decode = self.step
        self.stats = ServeStats()

    @property
    def captures(self) -> int:
        """CUDA-graph captures of the decode step (0 on the CPU)."""
        return self.step.captures

    def generate(self, prompts: list[list[int]], max_new: int
                 ) -> list[list[int]]:
        """Serve ``prompts`` (<= batch) and return generated token lists.

        Prompt ingestion is token by token through the decode step (the
        cache-append path), exactly as the reference's; the prefill graph
        is not used here.  Each step's length is a 0-d int32 tensor on the
        model's device, as the reference's ``jnp.int32(step)``."""
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of "
                             f"{self.batch}")
        pad = self.batch - len(prompts)
        prompts = prompts + [[0]] * pad
        max_prompt = max(len(p) for p in prompts)
        outs: list[list[int]] = [[] for _ in prompts]
        device = self.model.device

        for step in range(max_prompt + max_new - 1):
            # feed prompt token if still in prompt, else feed last output
            feed = []
            for i, p in enumerate(prompts):
                if step < len(p):
                    feed.append(p[step])
                else:
                    feed.append(outs[i][-1] if outs[i] else 0)
            tok = torch.tensor(feed, dtype=torch.int32).to(device)[:, None]
            length = torch.full((), step, dtype=torch.int32, device=device)
            logits, self.cache = self.decode(
                self.params, self.cache, {"tokens": tok, "length": length})
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().tolist()
            self.stats.steps += 1
            for i, p in enumerate(prompts):
                if step >= len(p) - 1 and len(outs[i]) < max_new:
                    outs[i].append(int(nxt[i]))
                    self.stats.tokens_out += 1
        self.stats.requests_done += len(prompts) - pad
        return outs[: len(prompts) - pad if pad else None]
