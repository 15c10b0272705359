"""Mamba-2 block via the SSD (state-space duality) chunked algorithm (port
of ``repro/layers/ssd.py``).

Training/prefill runs the block-decomposed SSD form (arXiv:2405.21060 §6):
intra-chunk quadratic "attention" plus inter-chunk state passing — O(L·c)
instead of O(L²) — with a sequential loop over chunks carrying the state
recurrence, as the reference's ``lax.scan``.  Decode is the O(1) recurrent
step on a (H, P, N) state and updates the cache in place (the port's form
of the reference's donated cache), reading nothing back to the host.

The projections are crossbar-able; the selective scan is a recurrence,
not a static matmul, and the reference computes it in XLA ops outside any
Pallas kernel, so its port is plain torch (products on cuBLAS, elementwise
passes), as for the RG-LRU scan.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.dist.sharding import ParamSpec, fanin_init, zeros_init
from repro_torch.layers.linear import XbarMode, dense_apply, dense_spec
from repro_torch.layers.mlp import silu
from repro_torch.layers.norms import rmsnorm_apply, rmsnorm_spec


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1           # B/C groups (G)
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` as ``jnp.logaddexp(x, 0)`` writes it: max(x, 0)
    + log1p(exp(-|x|)), its derivative exp(x - softplus(x)) as
    ``logaddexp``'s jvp (``F.softplus`` is log1p(exp(x)) below 20 and x
    above).  The exp and log1p themselves round as the device's do."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def ssd_spec(cfg: SSDConfig, xbar: XbarMode | None = None) -> dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    proj_out = 2 * di + 2 * gn + H          # [z, x, B, C, dt]

    def a_log_init(gen, shape, dtype, device):
        a = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * 15.0 + 1.0          # U(1, 16)
        return torch.log(a).to(dtype)

    def dt_bias_init(gen, shape, dtype, device):
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
        dt = torch.exp(u * (hi - lo) + lo)
        # inverse softplus
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)

    def ones(gen, shape, dtype, device):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "in_proj": dense_spec(d, proj_out, ("fsdp", "heads"), xbar=xbar),
        "conv_w": ParamSpec((cfg.d_conv, cfg.conv_dim), (None, "heads"),
                            fanin_init(0)),
        "conv_b": ParamSpec((cfg.conv_dim,), ("heads",), zeros_init()),
        "a_log": ParamSpec((H,), (None,), a_log_init),
        "d_skip": ParamSpec((H,), (None,), ones),
        "dt_bias": ParamSpec((H,), (None,), dt_bias_init),
        "norm": rmsnorm_spec(di),
        "out_proj": dense_spec(di, d, ("heads", "fsdp"), xbar=xbar),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, L, C); w: (k, C)."""
    k, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:L, :] * w[0]          # the taps summed in order i = 0..
    for i in range(1, k):
        out = out + xp[:, i:i + L, :] * w[i]
    return silu(out + b)


def _chunk_body(S_prev, xb, dtb, Bb, Cb, A, mask, rep: int):
    """One chunk: (B,c,H,P), (B,c,H), (B,c,G,N) and the carried state
    (B,H,P,N) -> (new state, y (B,c,H,P))."""
    dA = dtb * A[None, None, :]                         # (B,c,H)
    cum = torch.cumsum(dA, dim=1)                       # (B,c,H)
    total = cum[:, -1, :]                               # (B,H)

    # intra-chunk: att[b,h,i,j] = C_i.B_j exp(cum_i-cum_j) dt_j, i>=j
    CB = torch.einsum("bcgi,bsgi->bgcs", Cb, Bb)        # (B,G,c,c)
    CB = CB.repeat_interleave(rep, dim=1)               # (B,H,c,c)
    cum_h = cum.movedim(2, 1)                           # (B,H,c)
    # clamped before exp: the masked upper triangle would overflow, and
    # inf * 0 puts NaN into the gradient
    decay = torch.exp(torch.clamp_max(
        cum_h[:, :, :, None] - cum_h[:, :, None, :], 0.0))
    att = torch.where(mask, CB * decay, 0.0)
    att = att * dtb.movedim(2, 1)[:, :, None, :]
    y_intra = torch.einsum("bhcs,bshp->bchp", att, xb)

    # local end-of-chunk state
    w = torch.exp(total[:, None, :] - cum) * dtb        # (B,c,H)
    Brep = Bb.repeat_interleave(rep, dim=2)             # (B,c,H,N)
    S_loc = torch.einsum("bsh,bshv,bshp->bhpv", w, Brep, xb)

    # inter-chunk contribution + state update
    Crep = Cb.repeat_interleave(rep, dim=2)             # (B,c,H,N)
    y_inter = torch.einsum("bshv,bhpv->bshp", Crep, S_prev) \
        * torch.exp(cum)[..., None]
    S_new = S_prev * torch.exp(total)[:, :, None, None] + S_loc
    return S_new, y_intra + y_inter


def _ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD.  x: (B,L,H,P); dt: (B,L,H); A: (H,) negative;
    Bm/Cm: (B,L,G,N).  Returns (y, final_state (B,H,P,N)) in dt's dtype
    (fp32 in the block, as the reference's; float64 for a reference run).

    Chunks run one after the other, carrying the inter-chunk state; under
    autograd each chunk's body is rematerialized (non-reentrant
    checkpoint, as the reference's ``@jax.checkpoint``), so peak memory
    holds one chunk's quadratic (c x c) tensors instead of all of them."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert L % chunk == 0
    nc = L // chunk
    rep = H // G
    wide = dt.dtype

    xc = x.to(wide).reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.to(wide).reshape(Bsz, nc, chunk, G, N)
    Cc = Cm.to(wide).reshape(Bsz, nc, chunk, G, N)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    body = (functools.partial(ckpt.checkpoint, _chunk_body,
                              use_reentrant=False)
            if torch.is_grad_enabled() else _chunk_body)
    S = torch.zeros((Bsz, H, P, N), dtype=wide, device=x.device)
    ys = []
    for c in range(nc):
        S, y = body(S, xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], A, mask,
                    rep)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P), S


def ssd_apply(params: dict, x: torch.Tensor, cfg: SSDConfig, *,
              cache: dict | None = None,
              xbar: XbarMode | None = None,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, L, d) (train/prefill; ``cache`` None, or a fresh one to fill)
    or (B, 1, d) decode with ``cache``: the cache is updated in place and
    returned.  A prefill with a cache writes the last d_conv - 1 pre-conv
    inputs and the final state into it; it needs L >= d_conv - 1."""
    B, L, _ = x.shape
    di, H, P = cfg.d_inner, cfg.n_heads, cfg.head_dim
    G, N = cfg.n_groups, cfg.d_state
    gn = G * N
    f32 = torch.float32
    if cache is not None and 1 < L < cfg.d_conv - 1:
        raise ValueError(
            f"a prefill of {L} tokens into a cache leaves fewer than "
            f"d_conv - 1 = {cfg.d_conv - 1} conv inputs to keep")

    zxbcdt = dense_apply(params["in_proj"], x, compute_dtype=compute_dtype,
                         xbar=xbar)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * gn, H], dim=-1)
    A = -torch.exp(params["a_log"].to(f32))
    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))

    if cache is not None and L == 1:
        # ---- decode: rolling conv state + recurrent state update ----
        window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                           dim=1)                               # (B,k,C)
        xbc_t = torch.einsum("bkc,kc->bc", window.to(f32),
                             params["conv_w"].to(f32))
        xbc_t = silu(xbc_t + params["conv_b"].to(f32))
        xi, Bt, Ct = torch.split(xbc_t, [di, gn, gn], dim=-1)
        xh = xi.reshape(B, H, P)
        rep = H // G
        Brep = Bt.reshape(B, G, N).repeat_interleave(rep, dim=1)  # (B,H,N)
        Crep = Ct.reshape(B, G, N).repeat_interleave(rep, dim=1)
        dA = torch.exp(dt[:, 0, :] * A[None, :])                # (B,H)
        S = cache["state"].to(f32)
        S = S * dA[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, 0, :], Brep, xh)
        y = torch.einsum("bhn,bhpn->bhp", Crep, S)
        y = y + params["d_skip"].to(f32)[None, :, None] * xh
        y = y.reshape(B, 1, di)
        cache["conv"].copy_(window[:, 1:])
        cache["state"].copy_(S)
        cache["length"].add_(1)
    else:
        xbc_conv = _causal_conv(xbc.to(f32), params["conv_w"].to(f32),
                                params["conv_b"].to(f32))
        xi, Bm, Cm = torch.split(xbc_conv, [di, gn, gn], dim=-1)
        xh = xi.reshape(B, L, H, P)
        Bm = Bm.reshape(B, L, G, N)
        Cm = Cm.reshape(B, L, G, N)
        # pad L to a chunk multiple; padded steps have dt=0 so the state
        # passes through unchanged (exp(0)=1 decay, zero input)
        chunk = min(cfg.chunk, L)
        pad = (-L) % chunk
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
        else:
            xh_p, Bm_p, Cm_p, dt_p = xh, Bm, Cm, dt
        y, S_final = _ssd_scan(xh_p, dt_p, A, Bm_p, Cm_p, chunk)
        y = y[:, :L]
        y = y + params["d_skip"].to(f32)[None, None, :, None] * xh
        y = y.reshape(B, L, di)
        if cache is not None:
            cache["conv"].copy_(xbc[:, -(cfg.d_conv - 1):, :])
            cache["state"].copy_(S_final)
            cache["length"].add_(L)

    # gated RMSNorm (the reference's order: norm, then the gate) and the
    # out projection
    y = rmsnorm_apply(params["norm"], y.to(compute_dtype))
    y = y * silu(z.to(compute_dtype))
    return dense_apply(params["out_proj"], y, compute_dtype=compute_dtype,
                       xbar=xbar), cache


def init_ssd_cache(cfg: SSDConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cuda") -> dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                              cfg.d_state), dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
