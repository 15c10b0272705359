"""Public wrappers around the crossbar kernels (port of the crossbar entry
points of ``repro/kernels/ops.py``).

Dispatch: CUDA tensors launch the hand-written kernel
(``crossbar.<name>_kernel``) or raise; CPU tensors take the kernel's plain
version (``crossbar.<name>_plain``), which plays the role the reference's
interpret mode plays on CPU.  There is no fallback from one to the other.
Nothing is padded: the kernels mask ragged edges themselves.

Each wrapper carries a plain integer ``launches`` that it increments where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.

``crossbar_matmul`` is the differentiable product: a
``torch.autograd.Function`` whose forward is the fwd kernel and whose
backward runs the bwd and dw kernels, on 8-bit error codes when
``error_quant``.

Not ported yet (ROADMAP): the TPU block autotuner, the tuned-block table
and the conductance pad cache (reference ``ops.py:60-255``), which tile for
the TPU's VMEM; the fused per-stage training wrapper
(``crossbar_train_stacked``) and the k-means and attention wrappers.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as q
from repro_torch.kernels import crossbar as xbk


def _dispatch(wrapper, name: str, *tensors, **kwargs):
    """Run ``name`` on core stacks: its plain version when every tensor
    (``dy_scale`` included) lies on the CPU, else its CUDA kernel on
    contiguous operands, counted on ``wrapper.launches``."""
    scale = kwargs.get("dy_scale")
    if all(t.device.type == "cpu" for t in tensors + (scale,)
           if t is not None):
        return getattr(xbk, f"{name}_plain")(*tensors, **kwargs)
    out = getattr(xbk, f"{name}_kernel")(
        *(t.contiguous() for t in tensors), **kwargs)
    wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# One crossbar (2-D conductances)
# ---------------------------------------------------------------------------

def crossbar_fwd(x: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, *, activation: bool = True,
                 adc_bits: int | None = None,
                 adc_range: float = 0.5) -> torch.Tensor:
    """y = ADC(h(x @ (G+ - G-))).  x (..., K); g± (K, N) -> (..., N).

    ``adc_bits`` enables the fused output-ADC epilogue (transport
    quantization without a separate op between layers)."""
    lead = x.shape[:-1]
    K, N = g_plus.shape
    y = _dispatch(crossbar_fwd, "crossbar_fwd", x.reshape(1, -1, K),
                  g_plus[None], g_minus[None], activation=activation,
                  adc_bits=adc_bits, adc_range=adc_range)
    return y.reshape(*lead, N)


crossbar_fwd.launches = 0


def crossbar_bwd(dy: torch.Tensor, g_plus: torch.Tensor,
                 g_minus: torch.Tensor, *,
                 dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """dx = dequant(dy) @ (G+ - G-)^T.  dy (..., N); g± (K, N) -> (..., K).

    With ``dy_scale``, ``dy`` holds integer sign-magnitude error codes,
    dequantized in-kernel as ``codes * scale``."""
    lead = dy.shape[:-1]
    K, N = g_plus.shape
    dx = _dispatch(crossbar_bwd, "crossbar_bwd", dy.reshape(1, -1, N),
                   g_plus[None], g_minus[None], dy_scale=dy_scale)
    return dx.reshape(*lead, K)


crossbar_bwd.launches = 0


def crossbar_dw(x: torch.Tensor, dy: torch.Tensor, *,
                dy_scale: torch.Tensor | None = None) -> torch.Tensor:
    """dw = x^T @ dequant(dy), summed over every leading axis.
    x (..., K); dy (..., N) -> (K, N)."""
    K, N = x.shape[-1], dy.shape[-1]
    return _dispatch(crossbar_dw, "crossbar_dw", x.reshape(1, -1, K),
                     dy.reshape(1, -1, N), dy_scale=dy_scale)[0]


crossbar_dw.launches = 0


def pulse_update(g_plus: torch.Tensor, g_minus: torch.Tensor,
                 x: torch.Tensor, delta: torch.Tensor, *, lr: float,
                 max_dw: float = 0.05, levels: int = 128,
                 w_max: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pulse update.  x (..., K); delta (..., N); g± (K, N) -> the
    new (g+, g-)."""
    K, N = g_plus.shape
    gp, gm = _dispatch(pulse_update, "pulse_update", g_plus[None],
                       g_minus[None], x.reshape(1, -1, K),
                       delta.reshape(1, -1, N), lr=lr, max_dw=max_dw,
                       levels=levels, w_max=w_max)
    return gp[0], gm[0]


pulse_update.launches = 0


# ---------------------------------------------------------------------------
# The differentiable crossbar product (the training path)
# ---------------------------------------------------------------------------

class _CrossbarMatmul(torch.autograd.Function):
    """y = x @ (G+ - G-) on the kernels; backward on 8-bit error codes."""

    @staticmethod
    def forward(ctx, x, g_plus, g_minus, error_quant, err_bits):
        ctx.save_for_backward(x, g_plus, g_minus)
        ctx.error_quant, ctx.err_bits = error_quant, err_bits
        return crossbar_fwd(x, g_plus, g_minus, activation=False)

    @staticmethod
    def backward(ctx, dy):
        x, g_plus, g_minus = ctx.saved_tensors
        if ctx.error_quant:
            # 8-bit sign-magnitude error transport (paper III.F step 1):
            # the codes feed both kernels, dequantized in-kernel.
            qt = q.error_quantize(dy, ctx.err_bits)
            dx = crossbar_bwd(qt.codes, g_plus, g_minus, dy_scale=qt.scale)
            dw = crossbar_dw(x, qt.codes, dy_scale=qt.scale)
        else:
            dx = crossbar_bwd(dy, g_plus, g_minus)
            dw = crossbar_dw(x, dy)
        # d/dg_plus = +dw, d/dg_minus = -dw: the two columns move
        # oppositely (the +dw/2 / -dw/2 hardware update convention).
        return dx, dw, -dw, None, None


def crossbar_matmul(x: torch.Tensor, g_plus: torch.Tensor,
                    g_minus: torch.Tensor, *, error_quant: bool = False,
                    err_bits: int = 8) -> torch.Tensor:
    """Differentiable y = x @ (G+ - G-) on the kernel path.

    Forward runs the fwd kernel; ``backward`` runs the bwd + dw kernels with
    the incoming error optionally quantized to ``err_bits`` sign-magnitude
    codes (dequantized in-kernel) — the same semantics as the reference
    ``core.crossbar._xbar_matmul`` VJP."""
    return _CrossbarMatmul.apply(x, g_plus, g_minus, error_quant, err_bits)


# ---------------------------------------------------------------------------
# Stacked (multicore) entry points — the virtual chip's execution engine
# ---------------------------------------------------------------------------
# A pipeline stage holds T physical cores as stacked conductances
# (T, rows, cols); all cores of a stage run as ONE launch over the core
# axis.  Every stacked entry point also accepts one extra leading chip axis
# — (C, T, M, K) instead of (T, M, K) — which folds into the core stack.

def _fold_chip_axis(*arrays):
    """Fold an optional leading chip axis into the core-stack axis.

    All arrays must share ndim (3 = no chip axis, 4 = (C, T, ...)).
    Returns (folded_arrays, unfold) where ``unfold(y)`` restores the chip
    axis on a (C*T, ...) result."""
    ndims = {a.dim() for a in arrays}
    if ndims == {3}:
        return arrays, lambda y: y
    if ndims != {4}:
        raise ValueError(f"stacked operands must all be rank 3 or all "
                         f"rank 4, got ndims {sorted(ndims)}")
    C = arrays[0].shape[0]
    if any(a.shape[0] != C for a in arrays):
        raise ValueError("mismatched chip axis across stacked operands")
    folded = tuple(a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
                   for a in arrays)
    return folded, lambda y: y.reshape((C, y.shape[0] // C) + y.shape[1:])


def crossbar_fwd_stacked(xs: torch.Tensor, g_plus: torch.Tensor,
                         g_minus: torch.Tensor, *, activation: bool = False,
                         adc_bits: int | None = None,
                         adc_range: float = 0.5) -> torch.Tensor:
    """Batched multi-core forward: one launch evaluates T crossbars.

    xs (T, M, K); g± (T, K, N) -> (T, M, N).  Core t computes
    ``xs[t] @ (g_plus[t] - g_minus[t])`` — the per-stage dispatch of the
    virtual chip, where slice t is one physical core's conductance array.
    A leading chip axis — xs (C, T, M, K); g± (C, T, K, N) — folds into the
    core stack, so a whole farm executes as the same single launch.
    """
    (xs, g_plus, g_minus), unfold = _fold_chip_axis(xs, g_plus, g_minus)
    return unfold(_dispatch(crossbar_fwd_stacked, "crossbar_fwd", xs,
                            g_plus, g_minus, activation=activation,
                            adc_bits=adc_bits, adc_range=adc_range))


crossbar_fwd_stacked.launches = 0


def crossbar_bwd_stacked(dys: torch.Tensor, g_plus: torch.Tensor,
                         g_minus: torch.Tensor, *,
                         dy_scale: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Batched multi-core error backprop: dx[t] = dys[t] @ (G+ - G-)[t]^T.

    dys (T, M, N); g± (T, K, N) -> (T, M, K).  The virtual chip drives each
    core's error through its own conductances (Eq. 7 / Fig. 9), all cores
    of a stage in one launch.  A leading chip axis folds like
    :func:`crossbar_fwd_stacked`; ``dy_scale`` as in :func:`crossbar_bwd`.
    """
    (dys, g_plus, g_minus), unfold = _fold_chip_axis(dys, g_plus, g_minus)
    return unfold(_dispatch(crossbar_bwd_stacked, "crossbar_bwd", dys,
                            g_plus, g_minus, dy_scale=dy_scale))


crossbar_bwd_stacked.launches = 0


def crossbar_dw_stacked(xs: torch.Tensor, dys: torch.Tensor, *,
                        dy_scale: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Batched multi-core weight gradient: dw[t] = xs[t]^T @ dys[t]
    (batch-summed outer products, the paper's Eq. 6 per core).

    xs (T, M, K); dys (T, M, N) -> (T, K, N).  A leading chip axis folds
    like :func:`crossbar_fwd_stacked`."""
    (xs, dys), unfold = _fold_chip_axis(xs, dys)
    return unfold(_dispatch(crossbar_dw_stacked, "crossbar_dw", xs, dys,
                            dy_scale=dy_scale))


crossbar_dw_stacked.launches = 0


def pulse_update_stacked(g_plus: torch.Tensor, g_minus: torch.Tensor,
                         xs: torch.Tensor, deltas: torch.Tensor, *,
                         lr: float, max_dw: float = 0.05, levels: int = 128,
                         w_max: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-core pulse update (paper III.F step 3) on conductance
    stacks: xs (T, M, K); deltas (T, M, N); g± (T, K, N) -> new stacks.

    Each core's outer product, pulse discretization and clipping run in one
    launch for the whole stage — the virtual chip's update phase.  A
    leading chip axis folds like :func:`crossbar_fwd_stacked` (independent
    per-chip updates)."""
    (g_plus, g_minus, xs, deltas), unfold = _fold_chip_axis(
        g_plus, g_minus, xs, deltas)
    gp, gm = _dispatch(pulse_update_stacked, "pulse_update", g_plus,
                       g_minus, xs, deltas, lr=lr, max_dw=max_dw,
                       levels=levels, w_max=w_max)
    return unfold(gp), unfold(gm)


pulse_update_stacked.launches = 0
