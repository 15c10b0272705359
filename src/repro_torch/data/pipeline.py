"""Deterministic, resumable, shardable token stream (port of
``repro/data/pipeline.py``).

The batch at a step is a pure function of (seed, step, shard): a restarted
job replays the identical stream, each data-parallel host draws only its
slice, and a checkpoint stores nothing of the stream but the integer
step.  The draws come from a CPU ``torch.Generator`` seeded from (seed,
step, shard), so the stream differs from the reference's ``jax.random``
one; its statements (determinism, restart, disjoint shards, a learnable
signal) hold port against port, and a test that needs the reference's
tokens hands the reference's batch to the port.

``TokenStream`` synthesizes language-model token batches with a mixture of
Zipfian unigram draws and repeated n-gram motifs so the cross-entropy is
learnable.  Batches are int32 tensors on the CPU; the trainer moves them
to its device.
"""
from __future__ import annotations

import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15        # 2^64 / golden ratio, odd
_MOTIF_SALT = 0x5EED             # the reference's motif key: seed ^ 0x5EED


def _generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded by folding ``keys`` in order: one stream per
    key tuple."""
    h = 0
    for k in keys:
        h = (h * _MIX + k + 1) % 2 ** 64
    return torch.Generator().manual_seed(h)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def _motifs(self) -> torch.Tensor:
        gen = _generator(self.seed ^ _MOTIF_SALT)
        return torch.randint(0, self.vocab_size,
                             (self.n_motifs, self.motif_len), generator=gen)

    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1
                 ) -> dict[str, torch.Tensor]:
        """Batch for ``step``, restricted to this host's shard.

        tokens: (local_batch, seq_len) int32; the label stream is the input
        shifted by one (next-token prediction)."""
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {num_shards} shards")
        local = self.global_batch // num_shards
        gen = _generator(self.seed, step, shard)
        width = self.seq_len + 1

        # Zipfian unigrams: rank r has mass ~ 1/(r+1), drawn by inverse CDF
        mass = 1.0 / torch.arange(1, self.vocab_size + 1,
                                  dtype=torch.float64)
        cdf = torch.cumsum(mass, 0)
        u = torch.rand(local * width, generator=gen, dtype=torch.float64)
        base = torch.searchsorted(cdf, u * cdf[-1], right=True)
        base = torch.clamp(base, max=self.vocab_size - 1).reshape(local, width)

        # Overwrite random windows with repeated motifs (learnable signal)
        motifs = self._motifs()
        midx = torch.randint(0, self.n_motifs, (local,), generator=gen)
        pos = torch.randint(0, max(width - self.motif_len, 1), (local,),
                            generator=gen)
        cols = torch.arange(width)[None, :]
        in_motif = (cols >= pos[:, None]) & (cols < pos[:, None]
                                            + self.motif_len)
        motif_col = torch.clamp(cols - pos[:, None], 0, self.motif_len - 1)
        seq = torch.where(in_motif, motifs[midx[:, None], motif_col], base)
        return {"tokens": seq[:, :-1].to(torch.int32),
                "labels": seq[:, 1:].to(torch.int32)}

    def host_iterator(self, start_step: int, *, shard: int = 0,
                      num_shards: int = 1):
        step = start_step
        while True:
            yield step, self.batch_at(step, shard=shard,
                                      num_shards=num_shards)
            step += 1
