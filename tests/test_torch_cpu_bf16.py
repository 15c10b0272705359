"""The port's bf16 products on the CPU (``repro_torch.layers.products``)
against the reference's bf16 dot, and the run-to-run steadiness of a
bf16 training loss that reaches them.

oneDNN's multithreaded AMX bf16 GEMM, which ``torch`` on the CPU takes
for a bf16 ``@`` or ``einsum``, returns NaN or wrong values from finite
operands in some processes (most often when the machine is loaded).  The
port's CPU path takes every bf16 product as the fp32 product of the
operands' exact fp32 values, rounded once to bf16, which is the
reference's own program: XLA converts a bf16 dot's operands to f32,
takes the f32 dot and converts the result (checked here on its HLO).

Tolerances, each with its reason:
- the products: equal to ``jnp.dot`` / ``jnp.einsum`` bit for bit,
  except where torch's fp32 sum differs from XLA's (the same exact fp32
  products summed in another order) and the fp32 value lies within 1e-5
  of a bf16 rounding boundary, relative to the sum of the products'
  magnitudes (an fp32 sum of K terms in another order moves by at most
  about K 2^-24 of it; counted, a few in 10^4).  The reference's bf16 dot
  equals its own f32 dot rounded once, bit for bit.
- the wire-mode loss: bit-equal across processes, and finite.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import products  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NEAR = 1e-5          # distance to a bf16 midpoint, relative to sum |a b|

# (a, b) operand shapes: the wire-mode model's products that returned NaN
# (tokens x d_model times d_model x d_out), and a wider and a deeper one
SHAPES = [((128, 64), (64, 64)), ((128, 64), (64, 32)),
          ((128, 64), (64, 512)), ((64, 256), (256, 64))]


def _operands(sa, sb, seed):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal(sa) * 2.0, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(sb) * 0.3, jnp.bfloat16)
    to_t = lambda x: torch.tensor(              # noqa: E731
        np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    return a, b, to_t(a), to_t(b)


def _near_midpoint(v: np.ndarray, mag: np.ndarray) -> np.ndarray:
    """Whether fp32 ``v`` lies within NEAR ``mag`` (the sum of its
    products' magnitudes) of a value halfway between two neighbouring
    bf16 values."""
    t = torch.from_numpy(v)
    lo = (t.view(torch.int32) & ~0xFFFF).view(torch.float32)  # toward 0
    _, e = torch.frexp(lo)            # |lo| in [2^(e-1), 2^e): bf16 step
    mid = lo + torch.sign(t) * torch.ldexp(torch.ones_like(t), e - 9)
    return (torch.abs(t - mid) <= NEAR * torch.from_numpy(mag)).numpy()


def _check(got: torch.Tensor, want, t32: torch.Tensor, x32,
           mag: torch.Tensor, what: str):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    t32, x32 = t32.numpy(), np.asarray(x32)
    miss = got != want
    excused = miss & (t32 != x32) & _near_midpoint(t32, mag.numpy())
    assert np.isfinite(got).all(), what
    assert not (miss & ~excused).any(), (
        f"{what}: {int((miss & ~excused).sum())} unexcused misses")
    assert excused.sum() <= 1e-3 * got.size, (what, int(excused.sum()))
    print(f"{what}: {int(excused.sum())} of {got.size} one step apart at a "
          f"rounding boundary")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_product_is_the_reference_dot(sa, sb, seed):
    a, b, ta, tb = _operands(sa, sb, seed)
    got = products.matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    t32 = ta.float() @ tb.float()
    x32 = jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32))
    # the reference's bf16 dot is its f32 dot rounded once
    np.testing.assert_array_equal(
        np.asarray(jnp.dot(a, b).astype(jnp.float32)),
        np.asarray(x32.astype(jnp.bfloat16).astype(jnp.float32)))
    assert torch.equal(got, t32.to(torch.bfloat16))
    mag = ta.float().abs() @ tb.float().abs()
    _check(got, jnp.dot(a, b), t32, x32, mag, f"{sa} @ {sb}")


def test_reference_dot_is_convert_f32_dot_convert():
    """XLA's program for a bf16 dot on the CPU: the operands converted to
    f32, an f32 dot, the result converted to bf16."""
    hlo = jax.jit(jnp.dot).lower(
        jnp.zeros((128, 64), jnp.bfloat16),
        jnp.zeros((64, 32), jnp.bfloat16)).compile().as_text()
    dots = [ln for ln in hlo.splitlines() if " dot(" in ln]
    assert dots and all("f32[128,32]" in ln.split("=")[1] for ln in dots)


@pytest.mark.parametrize("seed", range(2))
def test_einsum_is_the_reference_einsum(seed):
    """The MoE expert product's contraction ("gecd,edf->gecf") and the
    crossbar backward's batch-summed outer product."""
    rng = np.random.default_rng(seed)
    for eq, sa, sb in (("gecd,edf->gecf", (2, 4, 8, 64), (4, 64, 32)),
                       ("...i,...j->ij", (2, 64, 64), (2, 64, 32))):
        a = jnp.asarray(rng.standard_normal(sa), jnp.bfloat16)
        b = jnp.asarray(rng.standard_normal(sb) * 0.3, jnp.bfloat16)
        ta, tb = (torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16) for x in (a, b))
        got = products.einsum(eq, ta, tb)
        t32 = torch.einsum(eq, ta.float(), tb.float())
        x32 = jnp.einsum(eq, a.astype(jnp.float32), b.astype(jnp.float32))
        mag = torch.einsum(eq, ta.float().abs(), tb.float().abs())
        _check(got, jnp.einsum(eq, a, b), t32, x32, mag, eq)


def test_gradients_are_fp32_products_rounded_once():
    """Under autograd each gradient product is the fp32 product rounded
    once to the operand's dtype (the reference's transposed bf16 dots)."""
    _, _, ta, tb = _operands((128, 64), (64, 32), 7)
    a, b = ta.clone().requires_grad_(True), tb.clone().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (128, 32)).astype(np.float32)).to(torch.bfloat16)
    da, db = torch.autograd.grad(products.matmul(a, b), (a, b), g)
    assert da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(da, (g.float() @ tb.float().T).to(torch.bfloat16))
    assert torch.equal(db, (ta.float().T @ g.float()).to(torch.bfloat16))


def test_fp32_and_counted_products_are_the_plain_ones():
    """fp32 operands, and bf16 ones while a count of the card's work is
    active (the dry run's counter), take the plain ``@``."""
    x = torch.randn(8, 16)
    w = torch.randn(16, 4)
    assert torch.equal(products.matmul(x, w), x @ w)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    seen = []

    def hook(fn, args, kwargs):
        return fn(*args, **kwargs)

    tops.PLAIN_HOOKS.append(hook)
    try:
        from torch.utils._python_dispatch import TorchDispatchMode

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append((func, args[0].dtype if args else None))
                return func(*args, **(kwargs or {}))

        with Ops():
            products.matmul(xb, wb)
    finally:
        tops.PLAIN_HOOKS.remove(hook)
    assert seen == [(torch.ops.aten.mm.default, torch.bfloat16)]


WIRE_LOSS = """
import numpy as np, torch
from repro_torch.configs import base as tcfg
from repro_torch.models import build_model
cfg = tcfg.get_reduced_config("yi-6b", crossbar=True, xbar_paired=False)
model = build_model(cfg, "cpu")
params = model.init(torch.Generator().manual_seed(0))
rng = np.random.default_rng(1)
batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                             .astype(np.int32)) for k in ("tokens", "labels")}
with torch.no_grad():
    loss, _ = model.loss_fn(params, batch)
print(torch.get_num_threads(), float(loss).hex())
"""


def test_wire_mode_loss_is_steady_across_processes():
    """The (w, common-mode) yi-6b loss of ``test_wire_mode_trains``, in 3
    fresh processes started together, each with its default thread count:
    finite and bit-equal in all three."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = str(REPO / "src")
    procs = [subprocess.Popen([sys.executable, "-c", WIRE_LOSS],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
             for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    threads = {int(t) for t, _ in outs}
    losses = [float.fromhex(v) for _, v in outs]
    assert threads and min(threads) >= 1
    assert all(np.isfinite(losses)), losses
    assert len({v for _, v in outs}) == 1, losses
