"""Decoder-only LM assembly: pattern-cycled blocks over stacked periods
(port of ``repro/models/lm.py``, the ``attn``, ``local`` and ``rec`` block
kinds).

The layer stack is grouped into *periods* (one cycle of
``cfg.block_pattern``), stacked on a leading axis as in the reference.
Where the reference runs them under ``jax.lax.scan``, the port runs a
Python loop over views of the stacked parameters (no copies; one
``unbind`` per stacked leaf, whose backward stacks the periods' gradients
in one pass) and casts each period's parameters to the compute dtype as
the reference's scan body does.  Layers that do not fill a whole period
(RecurrentGemma's trailing (rec, rec)) run after the periods, as the
reference's suffix does.  Decode caches are stacked the same way (a rec
block's conv window and state beside the attention blocks' k/v buffers)
and updated in place through views.

Under autograd a period's body is rematerialized as the reference's
``_remat_wrap`` asks (``cfg.remat``): ``"full"`` recomputes the whole
period in the backward (``torch.utils.checkpoint``, non-reentrant),
``"dots"`` saves the outputs of the products without batch dimensions
(the projections' ``mm``/``addmm``: JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest,
``"none"`` saves everything.  Remat wraps a period whatever its kinds
and changes no value.

Block kinds:
  attn   pre-norm self-attention + MLP          (dense archs)
  local  windowed self-attention + MLP          (recurrentgemma)
  rec    RG-LRU recurrent block + MLP           (recurrentgemma)

``moe`` and ``ssd`` blocks and VLM patches raise ``NotImplementedError``
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (cast_for_compute, stack_specs,
                                      tree_leaves, tree_map)
from repro_torch.layers import attention as attn_mod
from repro_torch.layers.attention import NOT_PORTED
from repro_torch.layers import embedding as emb_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import rglru as rglru_mod
from repro_torch.layers.linear import XbarMode
from repro_torch.layers.norms import (layernorm_apply, layernorm_spec,
                                      rmsnorm_apply, rmsnorm_spec)


def _norm_fns(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm_spec, layernorm_apply
    return rmsnorm_spec, rmsnorm_apply


KINDS = ("attn", "local", "rec")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is {NOT_PORTED}")


def _window(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.window if kind == "local" else None


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_spec(cfg: ModelConfig, kind: str, xbar: XbarMode | None) -> dict:
    _check_kind(kind)
    nspec, _ = _norm_fns(cfg)
    d = cfg.d_model
    if kind == "rec":
        mix = {"mix": rglru_mod.rglru_spec(cfg.rglru(), xbar)}
    else:
        mix = {"attn": attn_mod.attention_spec(
            cfg.attn(_window(cfg, kind)), xbar)}
    return {"ln1": nspec(d), **mix,
            "ln2": nspec(d),
            "mlp": mlp_mod.mlp_spec(d, cfg.d_ff, gated=cfg.gated_mlp,
                                    xbar=xbar)}


def block_apply(cfg: ModelConfig, kind: str, params: dict, x: torch.Tensor,
                *, positions: torch.Tensor, cache: dict | None,
                xbar: XbarMode | None, compute_dtype: torch.dtype
                ) -> tuple[torch.Tensor, dict | None]:
    _check_kind(kind)
    _, napply = _norm_fns(cfg)
    if kind == "rec":
        h, cache = rglru_mod.rglru_apply(
            params["mix"], napply(params["ln1"], x), cfg.rglru(),
            cache=cache, xbar=xbar, compute_dtype=compute_dtype)
    else:
        h, cache = attn_mod.attention_apply(
            params["attn"], napply(params["ln1"], x),
            cfg.attn(_window(cfg, kind)), positions=positions, cache=cache,
            xbar=xbar, compute_dtype=compute_dtype)
    x = x + h
    h = mlp_mod.mlp_apply(params["mlp"], napply(params["ln2"], x),
                          act=cfg.mlp_act, xbar=xbar,
                          compute_dtype=compute_dtype)
    return x + h, cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device) -> dict:
    """A block's decode cache: a rec block's conv window and state (fp32,
    whatever ``dtype``, as the reference's), else the attention cache of
    ``dtype``, rolling for a local block."""
    _check_kind(kind)
    if kind == "rec":
        return rglru_mod.init_rglru_cache(cfg.rglru(), batch, device=device)
    return attn_mod.init_self_cache(cfg.attn(_window(cfg, kind)), batch,
                                    max_len, dtype, device)


# ---------------------------------------------------------------------------
# Stack layout: prefix blocks, stacked periods, suffix blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackLayout:
    prefix: tuple[str, ...]
    pattern: tuple[str, ...]
    periods: int
    suffix: tuple[str, ...]


def stack_layout(cfg: ModelConfig) -> StackLayout:
    kinds = cfg.layer_kinds()
    prefix = tuple(kinds[: cfg.first_dense_layers])
    rest = kinds[cfg.first_dense_layers:]
    pat = cfg.block_pattern
    periods = len(rest) // len(pat)
    suffix = tuple(rest[periods * len(pat):])
    return StackLayout(prefix, pat, periods, suffix)


def _period_spec(cfg: ModelConfig, xbar) -> dict:
    return {f"b{i}_{k}": block_spec(cfg, k, xbar)
            for i, k in enumerate(cfg.block_pattern)}


def lm_spec(cfg: ModelConfig) -> dict:
    if cfg.vlm_patches:
        raise NotImplementedError(f"VLM patches are {NOT_PORTED}")
    xbar = XbarMode.from_config(cfg)
    lay = stack_layout(cfg)
    spec: dict[str, Any] = {
        "embed": emb_mod.embedding_spec(cfg.padded_vocab, cfg.d_model),
        "prefix": tuple(block_spec(cfg, k, xbar) for k in lay.prefix),
        "suffix": tuple(block_spec(cfg, k, xbar) for k in lay.suffix),
        "final_norm": _norm_fns(cfg)[0](cfg.d_model),
    }
    if lay.periods:
        spec["stack"] = stack_specs(_period_spec(cfg, xbar), lay.periods)
    if not cfg.tie_embeddings:
        spec["lm_head"] = emb_mod.lm_head_spec(cfg.d_model, cfg.padded_vocab,
                                               xbar)
    return spec


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device = "cuda") -> dict:
    lay = stack_layout(cfg)
    cache: dict[str, Any] = {
        "prefix": tuple(init_block_cache(cfg, k, batch, max_len, dtype,
                                         device) for k in lay.prefix),
        "suffix": tuple(init_block_cache(cfg, k, batch, max_len, dtype,
                                         device) for k in lay.suffix),
    }
    if lay.periods:
        period = {f"b{i}_{k}": init_block_cache(cfg, k, batch, max_len,
                                                dtype, device)
                  for i, k in enumerate(lay.pattern)}
        cache["stack"] = tree_map(
            lambda a: a[None].expand((lay.periods,) + a.shape).clone(),
            period)
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

# the products without batch dimensions: what "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` rematerialized as ``cfg.remat`` asks (the reference's
    ``_remat_wrap``); only under autograd, where it saves memory."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    if cfg.vlm_patches:
        raise NotImplementedError(f"VLM patches are {NOT_PORTED}")
    return emb_mod.embed_apply(params["embed"], batch["tokens"],
                               compute_dtype)


def _unstack(tree: Any) -> list[Any]:
    """A tree of stacked leaves -> one tree of views per period, from one
    ``unbind`` per leaf."""
    views = [a.unbind(0) for a in tree_leaves(tree)]
    out = []
    for p in range(len(views[0])):
        it = iter(v[p] for v in views)
        out.append(tree_map(lambda _: next(it), tree))
    return out


def lm_forward(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor, caches: dict | None = None
               ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, L, d) embedded inputs -> (hidden, caches).  ``caches`` (decode)
    are updated in place and returned; prefill passes None."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    xbar = XbarMode.from_config(cfg)
    lay = stack_layout(cfg)

    def run(kind, p, x, c):
        return block_apply(cfg, kind, p, x, positions=positions, cache=c,
                           xbar=xbar, compute_dtype=compute_dtype)[0]

    for i, kind in enumerate(lay.prefix):
        x = run(kind, params["prefix"][i], x,
                caches["prefix"][i] if caches else None)

    def period(x, p_params, p_cache):
        # cast as the reference's scan body, inside what remat recomputes
        p_params = cast_for_compute(p_params, compute_dtype)
        for i, kind in enumerate(lay.pattern):
            key = f"b{i}_{kind}"
            x = run(kind, p_params[key], x,
                    p_cache[key] if p_cache is not None else None)
        return x

    body = _remat_wrap(cfg, period)
    stack = _unstack(params["stack"]) if lay.periods else []
    for p, p_params in enumerate(stack):
        p_cache = (tree_map(lambda a: a[p], caches["stack"])
                   if caches is not None else None)
        x = body(x, p_params, p_cache)
    for i, kind in enumerate(lay.suffix):
        x = run(kind, params["suffix"][i], x,
                caches["suffix"][i] if caches else None)

    x = _norm_fns(cfg)[1](params["final_norm"], x)
    return x, caches


def lm_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor
              ) -> torch.Tensor:
    compute_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = emb_mod.lm_head_apply({}, hidden,
                                       tied_table=params["embed"]["table"],
                                       compute_dtype=compute_dtype,
                                       valid_vocab=cfg.vocab_size)
    else:
        logits = emb_mod.lm_head_apply(params["lm_head"], hidden,
                                       compute_dtype=compute_dtype,
                                       valid_vocab=cfg.vocab_size)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits
