"""Token embedding + LM head (port of ``repro/layers/embedding.py``).

``embed_apply`` gathers rows and then casts them: the same values as the
reference's cast-then-gather, without casting the whole table per call.
The head's product is taken in the compute dtype (bf16 logits widened to
fp32, as the reference's); pad columns past ``valid_vocab`` are -1e30.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import ParamSpec, normal_init
from repro_torch.layers.linear import XbarMode, dense_spec

NEG_INF = -1e30


def embedding_spec(vocab: int, d_model: int) -> dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "fsdp"),
                               normal_init(0.02))}


def embed_apply(params: dict, tokens: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    return params["table"][tokens].to(compute_dtype)


def lm_head_spec(d_model: int, vocab: int,
                 xbar: XbarMode | None = None) -> dict:
    return dense_spec(d_model, vocab, ("fsdp", "vocab"), xbar=xbar)


def lm_head_apply(params: dict, x: torch.Tensor, *,
                  tied_table: torch.Tensor | None = None,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  valid_vocab: int | None = None) -> torch.Tensor:
    if tied_table is not None:
        logits = x.to(compute_dtype) @ tied_table.to(compute_dtype).T
    else:
        w = (params["w"] if "w" in params
             else params["g_plus"] - params["g_minus"]).to(compute_dtype)
        logits = x.to(compute_dtype) @ w
    logits = logits.to(torch.float32)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits[..., valid_vocab:] = NEG_INF
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross-entropy; logits fp32 (B, S, V), labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
