"""Encoder-decoder model, the seamless-m4t backbone (port of
``repro/models/encdec.py``).

Encoder: bidirectional self-attention blocks (RoPE on q and k, as the
reference's) over stubbed frame embeddings, which enter through
``src_proj``, a plain dense layer even in crossbar mode.  Decoder: causal
self-attention, cross-attention and FFN blocks.  Both stacks are stacked
on a leading layer axis, as the reference's; where the reference scans
them, the port loops over views (``lm._unstack``) and casts each layer's
parameters to the compute dtype inside the (rematerialized) body.

Decode caches: each layer's self KV cache, stacked over the L decoder
layers (``"length"`` of shape (L,)), beside the cross k/v ``{"k", "v"}``
of shape (L, B, S_src, K, hd), filled once from the encoder output by
``fill_cross_cache``; the self caches are updated in place through
views, as the LM's.  ``init_encdec_cache`` and ``fill_cross_cache``
default to bf16 whatever ``cfg.kv_cache_dtype`` says, as the reference's
do: a float32 decode reads bf16 cross k/v unless given
``dtype=torch.float32``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import cast_for_compute, stack_specs, tree_map
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import embedding as emb_mod
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.models.lm import _norm_fns, _remat_wrap, _unstack


def enc_block_spec(cfg: ModelConfig, xbar: XbarMode | None) -> dict:
    nspec, _ = _norm_fns(cfg)
    d = cfg.d_model
    return {"ln1": nspec(d), "attn": attn_mod.attention_spec(cfg.attn(), xbar),
            "ln2": nspec(d),
            "mlp": mlp_mod.mlp_spec(d, cfg.d_ff, gated=cfg.gated_mlp,
                                    xbar=xbar)}


def dec_block_spec(cfg: ModelConfig, xbar: XbarMode | None) -> dict:
    nspec, _ = _norm_fns(cfg)
    d = cfg.d_model
    return {"ln1": nspec(d), "self": attn_mod.attention_spec(cfg.attn(), xbar),
            "ln_x": nspec(d),
            "cross": attn_mod.attention_spec(cfg.attn(), xbar),
            "ln2": nspec(d),
            "mlp": mlp_mod.mlp_spec(d, cfg.d_ff, gated=cfg.gated_mlp,
                                    xbar=xbar)}


def encdec_spec(cfg: ModelConfig) -> dict:
    xbar = XbarMode.from_config(cfg)
    nspec = _norm_fns(cfg)[0]
    return {
        "src_proj": dense_spec(cfg.d_model, cfg.d_model, ("fsdp", None)),
        "embed": emb_mod.embedding_spec(cfg.padded_vocab, cfg.d_model),
        "encoder": stack_specs(enc_block_spec(cfg, xbar),
                               cfg.encoder_layers),
        "enc_norm": nspec(cfg.d_model),
        "decoder": stack_specs(dec_block_spec(cfg, xbar), cfg.n_layers),
        "final_norm": nspec(cfg.d_model),
        "lm_head": emb_mod.lm_head_spec(cfg.d_model, cfg.padded_vocab, xbar),
    }


def encode(cfg: ModelConfig, params: dict, src_frames: torch.Tensor
           ) -> torch.Tensor:
    """src_frames: (B, S, d) stubbed frontend embeddings -> encoder states
    (B, S, d) in the compute dtype."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    xbar = XbarMode.from_config(cfg)
    _, napply = _norm_fns(cfg)
    acfg = dataclasses.replace(cfg.attn(), causal=False)
    x = dense_apply(params["src_proj"], src_frames,
                    compute_dtype=compute_dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)

    def body(x, p):
        p = cast_for_compute(p, compute_dtype)
        h, _ = attn_mod.attention_apply(p["attn"], napply(p["ln1"], x), acfg,
                                        positions=positions, xbar=xbar,
                                        compute_dtype=compute_dtype)
        x = x + h
        return x + mlp_mod.mlp_apply(p["mlp"], napply(p["ln2"], x),
                                     act=cfg.mlp_act, xbar=xbar,
                                     compute_dtype=compute_dtype)

    body_w = _remat_wrap(cfg, body)
    for p in _unstack(params["encoder"]):
        x = body_w(x, p)
    return napply(params["enc_norm"], x)


def decode_stack(cfg: ModelConfig, params: dict, y: torch.Tensor, *,
                 positions: torch.Tensor, enc_out: torch.Tensor | None,
                 caches: dict | None = None
                 ) -> tuple[torch.Tensor, dict | None]:
    """Decoder over target embeddings ``y``.

    Train and prefill: ``caches`` None, ``enc_out`` given (each layer's
    cross k/v computed from it on the fly).  Decode: ``caches`` = {"self":
    stacked self caches, "cross": stacked k/v}, updated in place and
    returned."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    xbar = XbarMode.from_config(cfg)
    _, napply = _norm_fns(cfg)
    acfg = cfg.attn()

    def body(x, p, enc_out, cache):
        p = cast_for_compute(p, compute_dtype)
        self_c, cross_c = ((cache["self"], cache["cross"])
                           if cache is not None else (None, None))
        h, _ = attn_mod.attention_apply(
            p["self"], napply(p["ln1"], x), acfg, positions=positions,
            cache=self_c, xbar=xbar, compute_dtype=compute_dtype)
        x = x + h
        h, _ = attn_mod.attention_apply(
            p["cross"], napply(p["ln_x"], x), acfg, positions=positions,
            cache=cross_c, kv_source=enc_out, xbar=xbar,
            compute_dtype=compute_dtype)
        x = x + h
        return x + mlp_mod.mlp_apply(p["mlp"], napply(p["ln2"], x),
                                     act=cfg.mlp_act, xbar=xbar,
                                     compute_dtype=compute_dtype)

    body_w = _remat_wrap(cfg, body)
    for i, p in enumerate(_unstack(params["decoder"])):
        c = (tree_map(lambda a: a[i], caches) if caches is not None
             else None)
        y = body_w(y, p, enc_out, c)
    return napply(params["final_norm"], y), caches


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> dict:
    """Zeroed decode caches: the self caches of ``max_len`` slots stacked
    over the decoder's layers, and cross k/v of ``src_len`` slots."""
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    self_c = attn_mod.init_self_cache(cfg.attn(), batch, max_len, dtype,
                                      device)
    shape = (L, batch, src_len, K, hd)
    return {
        "self": tree_map(lambda a: a[None].expand((L,) + a.shape).clone(),
                         self_c),
        "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)},
    }


@torch.no_grad()
def fill_cross_cache(cfg: ModelConfig, params: dict, enc_out: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Each decoder layer's cross k/v from the encoder output, (L, B, S,
    K, hd) in ``dtype``: the projections of the layer's parameters as
    they lie (not cast first), in the compute dtype, as the reference's
    ``vmap`` takes them."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    xbar = XbarMode.from_config(cfg)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    B, S, _ = enc_out.shape
    ks, vs = [], []
    for p in _unstack(params["decoder"]):
        for name, out in (("wk", ks), ("wv", vs)):
            t = dense_apply(p["cross"][name], enc_out,
                            compute_dtype=compute_dtype, xbar=xbar)
            out.append(t.reshape(B, S, K, hd).to(dtype))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}
