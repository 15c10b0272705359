"""Batched serving loop: greedy decode with per-slot tracking (port of
``repro/runtime/serve_loop.py``).

A fixed-batch server: every slot carries its own prompt cursor and
generation state.  The decode step is the model's ``decode_fn`` on a
cache that it updates in place (the reference donates the cache to a
jitted step); each step reads back to the host only the argmax tokens,
as the reference's ``np.asarray`` does.

:class:`RequestQueue` is the shared front-end discipline: a FIFO of
fixed-shape requests with per-slot refill and completion tracking.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

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


class BatchedServer:
    """Greedy token server over a fixed decode batch, on the model's
    device."""

    def __init__(self, model: Model, params: Any, *, batch: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache = model.init_cache(batch, max_len, cache_dtype)
        self.decode = model.decode_fn
        self.stats = ServeStats()

    def generate(self, prompts: list[list[int]], max_new: int
                 ) -> list[list[int]]:
        """Serve ``prompts`` (<= batch) and return generated token lists.

        Prompt ingestion is token by token through the decode step (the
        cache-append path), exactly as the reference's; the prefill graph
        is not used here."""
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
            logits, self.cache = self.decode(
                self.params, self.cache, {"tokens": tok, "length": step})
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().tolist()
            self.stats.steps += 1
            for i, p in enumerate(prompts):
                if step >= len(p) - 1 and len(outs[i]) < max_new:
                    outs[i].append(int(nxt[i]))
                    self.stats.tokens_out += 1
        self.stats.requests_done += len(prompts) - pad
        return outs[: len(prompts) - pad if pad else None]
