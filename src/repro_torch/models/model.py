"""Model facade (port of ``repro/models/model.py``: the decoder-only
``_build_lm`` and the encoder-decoder ``_build_encdec``).

``build_model(cfg, device)`` returns a :class:`Model` with:

  spec           ParamSpec tree (drives init and param_count)
  init(gen)      concrete parameters, drawn from a ``torch.Generator`` on
                 the model's device
  abstract_params()  the same tree as ``meta`` tensors (nothing allocated)
  loss_fn        (params, batch) -> (ce + aux, {"ce", "aux"}), under
                 autograd (the training step differentiates it); aux is
                 the MoE blocks' load-balancing loss, 0 without them (the
                 encoder-decoder's: (ce, {"ce"}))
  prefill_fn     (params, batch) -> logits
  decode_fn      (params, cache, batch) -> (logits, cache); the cache is
                 updated in place (the reference donates it)
  init_cache     (batch, max_len[, dtype]) -> cache tree on the device
  input_specs    (kind, seq_len, global_batch) -> (shape, dtype) tuples

``prefill_fn`` and ``decode_fn`` run without autograd.  The device is
``cuda`` unless the caller passes ``device="cpu"``; a CUDA device without
a card raises.

The encoder-decoder family (``family="encdec"``) takes batches of
``src_frames`` (B, S, d) and ``tgt_tokens`` (B, L) (and ``labels`` to
train); its ``init_cache(batch, max_len, dtype=bf16, src_len=None)``
zeroes a cross cache of ``src_len`` (``max_len`` if None) slots, which a
server decodes against unless the caller fills ``cache["cross"]`` with
``encdec.fill_cross_cache``, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.layers.embedding import cross_entropy, embed_apply
from repro_torch.layers.rope import text_mrope_positions
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    spec: Any
    device: torch.device
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable
    input_specs: Callable

    def init(self, generator: torch.Generator) -> dict:
        """Parameters drawn from ``generator``, which must live on the
        model's device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the model on {self.device}")
        return shd.init_params(generator, self.spec)

    def abstract_params(self) -> dict:
        """The parameter tree as ``meta`` tensors: shapes and dtypes,
        nothing allocated (what a checkpoint restores into)."""
        return shd.abstract_params(self.spec)


def _positions_for(cfg: ModelConfig, B: int, L: int, *,
                   device: torch.device,
                   start: torch.Tensor | int = 0) -> torch.Tensor:
    """(B, L) positions start .. start + L - 1 (``start`` an int or a 0-d
    tensor on ``device``; no host read either way); an M-RoPE config's
    (B, L, 3), the three streams equal (patch tokens too, as the
    reference's)."""
    pos = torch.arange(L, device=device)[None, :] + start
    pos = pos.expand(B, L)
    if cfg.mrope_sections is not None:
        return text_mrope_positions(pos)
    return pos


def _build_lm(cfg: ModelConfig, device: torch.device) -> Model:
    spec = lm_mod.lm_spec(cfg)
    compute_dtype = getattr(torch, cfg.compute_dtype)

    def forward_logits(params, batch):
        B, L = batch["tokens"].shape
        x = lm_mod.embed_inputs(cfg, params, batch, compute_dtype)
        positions = _positions_for(cfg, B, L, device=x.device)
        h, _, aux = lm_mod.lm_forward(cfg, params, x, positions=positions)
        return lm_mod.lm_logits(cfg, params, h), aux

    def loss_fn(params, batch):
        logits, aux = forward_logits(params, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + aux, {"ce": loss, "aux": aux}

    @torch.no_grad()
    def prefill_fn(params, batch):
        logits, _ = forward_logits(params, batch)
        return logits

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        tok = batch["tokens"]                      # (B, 1)
        B = tok.shape[0]
        x = lm_mod.embed_inputs(cfg, params, {"tokens": tok}, compute_dtype)
        positions = _positions_for(cfg, B, 1, start=batch["length"],
                                   device=x.device)
        h, cache, _ = lm_mod.lm_forward(cfg, params, x,
                                        positions=positions, caches=cache)
        return lm_mod.lm_logits(cfg, params, h), cache

    def init_cache(batch: int, max_len: int,
                   dtype: torch.dtype | None = None,
                   device: str | torch.device = device) -> dict:
        dtype = getattr(torch, cfg.kv_cache_dtype) if dtype is None \
            else dtype
        return lm_mod.init_lm_cache(cfg, batch, max_len, dtype, device)

    def input_specs(kind: str, seq_len: int, global_batch: int):
        tok = ((global_batch, seq_len), torch.int32)
        patches = ({"patch_embeds": ((global_batch, cfg.vlm_patches,
                                      cfg.d_model), torch.float32)}
                   if cfg.vlm_patches else {})
        if kind == "train":
            return {"tokens": tok, "labels": tok, **patches}
        if kind == "prefill":
            return {"tokens": tok, **patches}
        # decode: one token, cache of seq_len capacity; shapes from a cache
        # built on the meta device (nothing allocated)
        batch = {"tokens": ((global_batch, 1), torch.int32),
                 "length": ((), torch.int32)}
        cache = shd.tree_map(lambda a: (tuple(a.shape), a.dtype),
                             init_cache(global_batch, seq_len,
                                        device="meta"))
        return batch, cache

    return Model(cfg, spec, device, loss_fn, prefill_fn, decode_fn,
                 init_cache, input_specs)


# ---------------------------------------------------------------------------
# Encoder-decoder family
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ModelConfig, device: torch.device) -> Model:
    spec = ed.encdec_spec(cfg)
    compute_dtype = getattr(torch, cfg.compute_dtype)

    def forward_logits(params, batch):
        enc_out = ed.encode(cfg, params, batch["src_frames"])
        B, L = batch["tgt_tokens"].shape
        # the reference's table.astype(compute)[tok]: the same values
        y = embed_apply(params["embed"], batch["tgt_tokens"], compute_dtype)
        positions = _positions_for(cfg, B, L, device=y.device)
        h, _ = ed.decode_stack(cfg, params, y, positions=positions,
                               enc_out=enc_out)
        return lm_mod.lm_logits(cfg, params, h)

    def loss_fn(params, batch):
        loss = cross_entropy(forward_logits(params, batch), batch["labels"])
        return loss, {"ce": loss}

    @torch.no_grad()
    def prefill_fn(params, batch):
        """Encode the source and score the target prefix (teacher-forced
        prefill)."""
        return forward_logits(params, batch)

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        tok = batch["tokens"]                      # (B, 1)
        y = embed_apply(params["embed"], tok, compute_dtype)
        positions = _positions_for(cfg, tok.shape[0], 1,
                                   start=batch["length"], device=y.device)
        h, cache = ed.decode_stack(cfg, params, y, positions=positions,
                                   enc_out=None, caches=cache)
        return lm_mod.lm_logits(cfg, params, h), cache

    def init_cache(batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   src_len: int | None = None,
                   device: str | torch.device = device) -> dict:
        return ed.init_encdec_cache(cfg, batch, max_len, src_len or max_len,
                                    dtype, device)

    def input_specs(kind: str, seq_len: int, global_batch: int):
        frames = ((global_batch, seq_len, cfg.d_model), torch.float32)
        tok = ((global_batch, seq_len), torch.int32)
        if kind == "train":
            return {"src_frames": frames, "tgt_tokens": tok, "labels": tok}
        if kind == "prefill":
            return {"src_frames": frames, "tgt_tokens": tok}
        batch = {"tokens": ((global_batch, 1), torch.int32),
                 "length": ((), torch.int32)}
        cache = shd.tree_map(lambda a: (tuple(a.shape), a.dtype),
                             init_cache(global_batch, seq_len,
                                        src_len=seq_len, device="meta"))
        return batch, cache

    return Model(cfg, spec, device, loss_fn, prefill_fn, decode_fn,
                 init_cache, input_specs)


def build_model(cfg: ModelConfig,
                device: str | torch.device = "cuda") -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` unless the caller asks
    for the CPU; raises without a card)."""
    if cfg.family == "encdec":
        return _build_encdec(cfg, resolve_device(device))
    return _build_lm(cfg, resolve_device(device))
