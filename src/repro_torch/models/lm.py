"""Decoder-only LM assembly: pattern-cycled blocks over stacked periods
(port of ``repro/models/lm.py``, the ``attn``, ``local``, ``rec``,
``moe`` and ``ssd`` block kinds).

The layer stack is grouped into *periods* (one cycle of
``cfg.block_pattern``), stacked on a leading axis as in the reference.
Where the reference runs them under ``jax.lax.scan``, the port runs a
Python loop over views of the stacked parameters (no copies; one
``unbind`` per stacked leaf, whose backward stacks the periods' gradients
in one pass) and casts each period's parameters to the compute dtype as
the reference's scan body does.  Layers that do not fill a whole period
run unscanned and uncast: the MoE configs' dense prefix
(``first_dense_layers``) before the periods, RecurrentGemma's trailing
(rec, rec) after them, as the reference's prefix and suffix do.  Decode
caches are stacked the same way (a rec or ssd block's conv window and
state beside the attention blocks' k/v buffers) and updated in place
through views.

Every block returns its auxiliary loss (a ``moe`` block's load-balancing
term; None for the others, whose term the reference adds as 0), and
``lm_forward`` sums them in the reference's order: the prefix, each
period in turn (the sum carried through the period body, as the scan's
carry, so it leaves the remat'd body as an output and its gradient
reaches the routers), then the suffix.

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
  moe    pre-norm self-attention + MoE FFN      (moe archs)
  ssd    Mamba-2 block (single residual)        (mamba2)

In bf16 compute an ssd block's parameters reach ``ssd_apply`` rounded to
bf16 by the period's cast (``a_log``, ``dt_bias`` and ``conv_w``
included), and it widens them, as the reference's.

A VLM config (``vlm_patches`` > 0) has a ``patch_merger``: a plain dense
layer (no bias, and no crossbar even in crossbar mode, as the
reference's) that ``embed_inputs`` applies to a batch's ``patch_embeds``
(B, P, d_model) and writes over token positions 0 .. P-1, out of place
(the reference's ``dynamic_update_slice``); a batch without them (decode,
the ``TokenStream`` CLI) merges nothing.
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
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import rglru as rglru_mod
from repro_torch.layers import ssd as ssd_mod
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.layers.norms import (layernorm_apply, layernorm_spec,
                                      rmsnorm_apply, rmsnorm_spec)


def _norm_fns(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm_spec, layernorm_apply
    return rmsnorm_spec, rmsnorm_apply


KINDS = ("attn", "local", "rec", "moe", "ssd")


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
    if kind == "ssd":
        return {"ln": nspec(d), "ssd": ssd_mod.ssd_spec(cfg.ssd(), xbar)}
    if kind == "rec":
        mix = {"mix": rglru_mod.rglru_spec(cfg.rglru(), xbar)}
    else:
        mix = {"attn": attn_mod.attention_spec(
            cfg.attn(_window(cfg, kind)), xbar)}
    if kind == "moe":
        ffn = {"moe": moe_mod.moe_spec(cfg.moe(), xbar)}
    else:
        ffn = {"mlp": mlp_mod.mlp_spec(d, cfg.d_ff, gated=cfg.gated_mlp,
                                       xbar=xbar)}
    return {"ln1": nspec(d), **mix, "ln2": nspec(d), **ffn}


def block_apply(cfg: ModelConfig, kind: str, params: dict, x: torch.Tensor,
                *, positions: torch.Tensor, cache: dict | None,
                xbar: XbarMode | None, compute_dtype: torch.dtype
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor | None]:
    """-> (x, cache, aux): ``aux`` the block's auxiliary loss, None where
    the block has none (the reference's zeros)."""
    _check_kind(kind)
    _, napply = _norm_fns(cfg)
    if kind == "ssd":
        h, cache = ssd_mod.ssd_apply(params["ssd"], napply(params["ln"], x),
                                     cfg.ssd(), cache=cache, xbar=xbar,
                                     compute_dtype=compute_dtype)
        return x + h, cache, None
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
    aux = None
    if kind == "moe":
        h, aux = moe_mod.moe_apply(params["moe"], napply(params["ln2"], x),
                                   cfg.moe(), xbar=xbar,
                                   compute_dtype=compute_dtype)
    else:
        h = mlp_mod.mlp_apply(params["mlp"], napply(params["ln2"], x),
                              act=cfg.mlp_act, xbar=xbar,
                              compute_dtype=compute_dtype)
    return x + h, cache, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, device) -> dict:
    """A block's decode cache: a rec or ssd block's conv window and state
    (fp32, whatever ``dtype``, as the reference's), else the attention
    cache of ``dtype`` (a moe block's self-attention too), rolling for a
    local block."""
    _check_kind(kind)
    if kind == "ssd":
        return ssd_mod.init_ssd_cache(cfg.ssd(), batch, device=device)
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
    if cfg.vlm_patches:
        spec["patch_merger"] = dense_spec(cfg.d_model, cfg.d_model,
                                          ("fsdp", None))
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
    x = emb_mod.embed_apply(params["embed"], batch["tokens"], compute_dtype)
    if cfg.vlm_patches and "patch_embeds" in batch:
        patches = dense_apply(params["patch_merger"], batch["patch_embeds"],
                              compute_dtype=compute_dtype)
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]],
                      dim=1)
    return x


def _unstack(tree: Any) -> list[Any]:
    """A tree of stacked leaves -> one tree of views per period, from one
    ``unbind`` per leaf."""
    views = [a.unbind(0) for a in tree_leaves(tree)]
    out = []
    for p in range(len(views[0])):
        it = iter(v[p] for v in views)
        out.append(tree_map(lambda _: next(it), tree))
    return out


def _add_aux(aux: torch.Tensor | None, a: torch.Tensor | None
             ) -> torch.Tensor | None:
    """The running auxiliary loss plus a block's (None is 0, as the
    reference's zeros: 0 + a is a, so the sums are the reference's)."""
    if a is None:
        return aux
    return a if aux is None else aux + a


def lm_forward(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor, caches: dict | None = None
               ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """x: (B, L, d) embedded inputs -> (hidden, caches, aux_loss).
    ``caches`` (decode) are updated in place and returned; prefill passes
    None.  ``aux_loss`` is the blocks' auxiliary losses summed in the
    reference's order (an fp32 0 where no block has one)."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    xbar = XbarMode.from_config(cfg)
    lay = stack_layout(cfg)

    def run(kind, p, x, c, aux):
        x, _, a = block_apply(cfg, kind, p, x, positions=positions, cache=c,
                              xbar=xbar, compute_dtype=compute_dtype)
        return x, _add_aux(aux, a)

    aux = None
    for i, kind in enumerate(lay.prefix):
        x, aux = run(kind, params["prefix"][i], x,
                     caches["prefix"][i] if caches else None, aux)

    def period(x, aux, p_params, p_cache):
        # cast as the reference's scan body, inside what remat recomputes
        p_params = cast_for_compute(p_params, compute_dtype)
        for i, kind in enumerate(lay.pattern):
            key = f"b{i}_{kind}"
            x, aux = run(kind, p_params[key], x,
                         p_cache[key] if p_cache is not None else None, aux)
        return x, aux

    body = _remat_wrap(cfg, period)
    stack = _unstack(params["stack"]) if lay.periods else []
    for p, p_params in enumerate(stack):
        p_cache = (tree_map(lambda a: a[p], caches["stack"])
                   if caches is not None else None)
        x, aux = body(x, aux, p_params, p_cache)
    for i, kind in enumerate(lay.suffix):
        x, aux = run(kind, params["suffix"][i], x,
                     caches["suffix"][i] if caches else None, aux)

    x = _norm_fns(cfg)[1](params["final_norm"], x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux


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
