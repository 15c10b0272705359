"""Mixture-of-Experts FFN with capacity-based GShard dispatch (port of
``repro/layers/moe.py``).

Tokens are bucketed into groups of ``min(group_size, B * S)``; within a
group each token picks its top-k experts and takes a slot in each
expert's capacity buffer, first come first served by a cumulative sum in
priority order (every top-1 choice of the group before any top-2
choice); a choice past the capacity is dropped.  The dataflow is the
reference's, step for step:

  router (fp32) -> softmax -> top-k -> gates renormalised (norm_topk_prob)
  aux = coef * E * sum_e mean_t(probs_e) * share_of_choices_e (Switch eq. 4)
  slot one-hot (G, k * s, E, C) in the compute dtype, summed over k into
      dispatch (unweighted) and combine (weighted by the gates)
  xe = einsum('gsec,gsd->gecd') -> expert SwiGLU -> ye (G, E, C, d)
  y  = einsum('gsec,gecd->gsd') (+ the shared expert's MLP)

Top-k takes the first k of a stable descending sort, so among equal
probabilities the lower expert index comes first, as ``jax.lax.top_k``
orders them (``torch.topk`` promises no order among ties, and a token's
slot is a cumulative sum over that order).  The one-hots are built by a
comparison with an ``arange`` directly in the compute dtype: their values
are 0 and 1, exact in bf16, and an int64 ``F.one_hot`` of
(G, k * s, E, C) would be four times the size.  The sums over k have one
nonzero term each, so dispatch and combine are exact.

The experts' SiLU is ``mlp.silu``, ``jax.nn.silu`` op for op.  The
einsums are cuBLAS products in the compute dtype on the card (on the
CPU ``layers.products``' fp32 form), as the reference's are XLA's: no
Pallas kernel stands behind them.  The router and the experts take no
crossbar (the reference's ``moe_spec``); the shared expert is an
``mlp_apply`` and takes the config's.

``ROUTING``: where it is a list, every call appends its :class:`Routing`
(device tensors, nothing read back to the host), which the parity tests
and ``chip_smoke.py``'s drop shares read; ``None``, the default, records
nothing.  Under remat a period's calls append again in the backward.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import ParamSpec, fanin_init
from repro_torch.layers import products
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.layers.mlp import mlp_apply, mlp_spec, silu


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN hidden size
    n_shared_experts: int = 0       # shared-expert multiplier (DeepSeek-style)
    capacity_factor: float = 1.25
    group_size: int = 1024
    norm_topk_prob: bool = True
    act: str = "silu"
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class Routing:
    """One ``moe_apply`` call's routing, for the tests and the smoke run.

    top_i   (G, s, k) chosen experts, in priority order
    margin  (G, s)    the least gap between two of the token's k + 1
                      largest probabilities (inf where there is one):
                      how near its choice, or their order, was to a tie
    kept    (G, k, s) which choices found a slot (False: dropped)
    """
    top_i: torch.Tensor
    margin: torch.Tensor
    kept: torch.Tensor


ROUTING: list[Routing] | None = None


def capture_records(capture) -> list:
    """Call ``capture`` (a CUDA-graph capture of a step) and return the
    records it appended to ``ROUTING``, taken out of the list: a capture
    executes nothing, so its records stand for what each replay routes
    (``replay_records``).  Nothing when ``ROUTING`` is not a list."""
    records = ROUTING
    n = len(records) if isinstance(records, list) else None
    capture()
    if n is None:
        return []
    taken = records[n:]
    del records[n:]
    return taken


def replay_records(records: list) -> None:
    """Append clones of a capture's records to ``ROUTING`` (where it is a
    list), as the eager step would have appended its own."""
    if records and isinstance(ROUTING, list):
        from repro_torch.graphs import clone_tree
        ROUTING.extend(clone_tree(r) for r in records)


def moe_spec(cfg: MoeConfig, xbar: XbarMode | None = None) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    init = fanin_init(1)  # fan-in is the middle (d) axis for stacked experts
    spec = {
        "router": dense_spec(d, E, ("fsdp", None)),
        "wg": ParamSpec((E, d, f), ("experts", "fsdp", None), init),
        "wi": ParamSpec((E, d, f), ("experts", "fsdp", None), init),
        "wo": ParamSpec((E, f, d), ("experts", None, "fsdp"), fanin_init(1)),
    }
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec(d, cfg.n_shared_experts * f, gated=True,
                                  xbar=xbar)
    return spec


def _capacity(cfg: MoeConfig, group: int) -> int:
    c = int(cfg.capacity_factor * group * cfg.top_k / cfg.n_experts)
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


def moe_apply(params: dict, x: torch.Tensor, cfg: MoeConfig, *,
              xbar: XbarMode | None = None,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    T = B * S
    g_size = min(cfg.group_size, T)
    if T % g_size:     # the reference asserts it
        raise ValueError(f"moe_apply: {T} tokens do not split into groups "
                         f"of {g_size}; more than group_size tokens must "
                         f"be a multiple of it")
    G = T // g_size
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, g_size)

    xt = x.reshape(G, g_size, d)
    logits = dense_apply(params["router"], xt,
                         compute_dtype=torch.float32)        # (G,s,E)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = ranked[..., :k], order[..., :k]           # (G,s,k)
    if cfg.norm_topk_prob:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # Load-balancing aux loss (Switch eq. 4): E * sum_e f_e * P_e.
    me = probs.mean(dim=(0, 1))                              # (E,)
    chosen = top_i[..., None] == torch.arange(E, device=x.device)
    ce = chosen.to(torch.float32).sum(dim=2).mean(dim=(0, 1)) / k
    aux = cfg.aux_loss_coef * E * torch.sum(me * ce)

    # Slot assignment: the k choices in priority order, so top-1 claims
    # capacity first (GShard); position in the expert by a cumsum.
    prio = chosen.to(torch.int32).transpose(1, 2).reshape(G, k * g_size, E)
    pos = torch.cumsum(prio, dim=1, dtype=torch.int32) - 1   # (G,k*s,E)
    keep = (pos < C) & (prio > 0)
    pos = torch.where(keep, pos, 0)
    slots = torch.arange(C, device=x.device)
    slot_oh = ((pos[..., None] == slots) & keep[..., None]).to(compute_dtype)
    slot_oh = slot_oh.reshape(G, k, g_size, E, C)
    dispatch = slot_oh.movedim(1, 2)                         # (G,s,k,E,C)

    gates = top_p.to(compute_dtype)[..., None, None]         # (G,s,k,1,1)
    combine = (dispatch * gates).sum(dim=2)                  # (G,s,E,C)
    dispatch = dispatch.sum(dim=2)                           # (G,s,E,C)

    xe = products.einsum("gsec,gsd->gecd", dispatch,
                         xt.to(compute_dtype))               # (G,E,C,d)
    wg = params["wg"].to(compute_dtype)
    wi = params["wi"].to(compute_dtype)
    wo = params["wo"].to(compute_dtype)
    h = silu(products.einsum("gecd,edf->gecf", xe, wg)) * \
        products.einsum("gecd,edf->gecf", xe, wi)
    ye = products.einsum("gecf,efd->gecd", h, wo)            # (G,E,C,d)

    y = products.einsum("gsec,gecd->gsd", combine, ye)       # (G,s,d)
    y = y.reshape(B, S, d)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, act=cfg.act, xbar=xbar,
                          compute_dtype=compute_dtype)
    if ROUTING is not None:
        top = ranked[..., :k + 1]
        margin = ((top[..., :-1] - top[..., 1:]).amin(dim=-1)
                  if top.shape[-1] > 1
                  else torch.full_like(top[..., 0], float("inf")))
        ROUTING.append(Routing(top_i.detach(), margin.detach(),
                               keep.any(dim=-1).reshape(G, k, g_size)))
    return y.to(x.dtype), aux
