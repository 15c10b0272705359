"""Port parity: the flash-attention wrapper
(``repro_torch.kernels.ops.flash_attention``, the plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.flash_attention``) and its oracle
(``repro.kernels.ref.flash_attention_ref``), and the port's plain
``"chunked"`` function against ``chunked_attention``, the reference
layer's own prefill attention, on the same numpy inputs.

Tolerances:
- fp32: 2e-5 absolute plus 2e-5 relative, the reference's own kernel bar
  (tests/test_kernels.py); the sides sum in different orders.
- bf16 against the Pallas kernel: one bf16 step, |a - b| <= spacing of
  bf16 at max(|a|, |b|) + 1e-6.  Both compute in fp32 and round once, so
  their fp32 values differ in the last bits and round at most one step
  apart.
- bf16 against the oracle: 4e-3 absolute plus relative (measured on
  the CPU: 1.6e-3, a 2.6x margin).  The oracle rounds its fp32 result
  once; the plain version's sums run in another order.
- bf16, the ``"chunked"`` plain version against ``chunked_attention`` at
  the same chunks: one bf16 step plus 2^-7 max_j p_j |v_j| / l (see
  ``assert_chunked_bar``; the Pallas function fails it at both shapes).  (The Pallas function against
  ``chunked_attention`` needed 3.9e-3 here; see
  tests/test_torch_chunked_attention.py for the repaired fault.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.layers.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 2e-5
BF16_TOL = 4e-3
# the reference's oracle and layer attention, one compile per shape
J_REF = jax.jit(jref.flash_attention_ref, static_argnames=("causal",))
J_CHUNKED = jax.jit(chunked_attention, static_argnames=(
    "scale", "causal", "window", "q_chunk", "kv_chunk"))

# (B, S, H, K, hd, causal): tests/test_kernels.py's four shapes, ragged S,
# GQA with G = 7 (qwen2-0.5b's 14 on 2 heads), MHA, non-causal
SHAPES = [
    (2, 64, 4, 2, 16, True), (1, 128, 2, 1, 32, True),
    (2, 64, 4, 4, 16, False), (1, 256, 2, 2, 64, True),
    (1, 96, 4, 2, 16, True), (2, 200, 2, 1, 32, True),
    (1, 128, 14, 2, 64, True), (1, 200, 4, 2, 16, False),
]


def _inputs(B, S, H, K, hd, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, Skv, K, hd), np.float32),
            rng.standard_normal((B, Skv, K, hd), np.float32))


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the same values in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def assert_one_bf16_step(got, want, what):
    got, want = _f32(got), _f32(want)
    bar = bf16_step(np.maximum(np.abs(got), np.abs(want))) + 1e-6
    err = np.abs(got - want)
    assert (err <= bar).all(), (what, float(err.max()))


def assert_chunked_bar(got, want, q, k, v, scale, causal, what):
    """bf16 outputs of ``chunked_attention``'s function on two sides at the
    same chunks: |got - want| <= one bf16 step at max(|got|, |want|) +
    1e-6 + 2^-7 max_j p_j |v_j| / l.  Both sides round p_j to bf16 against
    the same running max before p . v, but their fp32 scores sum q . k in
    other orders and may differ in the last bit; a p_j at a bf16 rounding
    boundary then rounds one step (at most 2^-7 p_j) apart, which moves
    the output by at most 2^-7 p_j |v_j| / l.  Each side rounds the output
    once: one step at the larger, in all."""
    got, want = _f32(got), _f32(want)
    B, S, H, hd = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          fak.NEG_INF)
    p = torch.softmax(s, dim=-1)                        # (B, K, G, S, S)
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    top = _f32((p[..., None] * va).amax(dim=-2).permute(0, 3, 1, 2, 4)
               .reshape(B, S, H, hd))                   # max_j p_j |v_j| / l
    bar = (bf16_step(np.maximum(np.abs(got), np.abs(want))) + 1e-6
           + 2.0 ** -7 * top)
    err = np.abs(got - want)
    assert (err <= bar).all(), (what, float(err.max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_and_oracle_fp32(shape):
    B, S, H, K, hd, causal = shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, H, K, hd, S + H), "float32")
    got = tops.flash_attention(q, k, v, scale=hd ** -0.5, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(
        _f32(got), _f32(jops.flash_attention(jq, jk, jv, causal=causal)),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        _f32(got), _f32(J_REF(jq, jk, jv, causal=causal)),
        atol=TOL, rtol=TOL)
    # the port's oracle is the reference's
    np.testing.assert_allclose(
        _f32(tref.flash_attention_ref(q, k, v, causal=causal)),
        _f32(J_REF(jq, jk, jv, causal=causal)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(1, 128, 2, 2, 32, True),
                                   (2, 96, 14, 2, 64, True),
                                   (1, 64, 4, 4, 16, False)])
def test_plain_matches_pallas_kernel_bf16(shape):
    B, S, H, K, hd, causal = shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, H, K, hd, 7), "bfloat16")
    got = tops.flash_attention(q, k, v, scale=hd ** -0.5, causal=causal)
    assert got.dtype == torch.bfloat16
    assert_one_bf16_step(got, jops.flash_attention(jq, jk, jv, causal=causal),
                         shape)
    np.testing.assert_allclose(
        _f32(got), _f32(J_REF(jq, jk, jv, causal=causal)),
        atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 14, 2, 64), (2, 64, 4, 2, 16)])
def test_plain_matches_chunked_attention(shape, dtype):
    """The reference layer's prefill attention: causal, no window,
    Sq == Skv, at its own chunk sizes (reduced configs use 32), against
    the port's plain ``"chunked"`` function at the same chunks."""
    B, S, H, K, hd = shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, H, K, hd, 11), dtype)
    scale = hd ** -0.5
    want = J_CHUNKED(jq, jk, jv, scale=scale, causal=True, window=None,
                     q_chunk=32, kv_chunk=32)
    got = fak.chunked_attention_plain(q, k, v, causal=True, scale=scale,
                                      q_chunk=32, kv_chunk=32)
    assert got.dtype == q.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)
    else:
        assert_chunked_bar(got, want, q, k, v, scale, True, shape)
        old = fak.flash_attention_plain(q, k, v, causal=True, scale=scale)
        with pytest.raises(AssertionError):     # the old prefill's function
            assert_chunked_bar(old, want, q, k, v, scale, True, shape)


def test_scale_is_passed_through():
    (_, _, _), (q, k, v) = _both(_inputs(1, 32, 2, 1, 16, 3), "float32")
    a = tops.flash_attention(q, k, v, scale=0.5)
    b = fak.flash_attention_plain(q, k, v, scale=0.5, causal=True)
    c = tops.flash_attention(q, k, v, scale=0.25)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, fak.flash_attention_plain(q, k, v, scale=0.25))
    assert torch.equal(c, tref.flash_attention_ref(q, k, v))   # hd ** -0.5


def test_causal_mask_counts_from_zero_on_both_sides():
    """Sq != Skv keeps the Pallas kernel's mask: query i sees keys 0..i."""
    (_, _, _), (q, k, v) = _both(_inputs(1, 8, 2, 1, 16, 5, Skv=24),
                                 "float32")
    got = tops.flash_attention(q, k, v, scale=0.25, causal=True)
    want = tops.flash_attention(q, k[:, :8], v[:, :8], scale=0.25,
                                causal=True)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_version_and_are_not_counted():
    (_, _, _), (q, k, v) = _both(_inputs(1, 64, 4, 2, 16, 1), "float32")
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, scale=16 ** -0.5)
    assert tops.flash_attention.launches == before
    assert torch.equal(got, fak.flash_attention_plain(q, k, v,
                                                      scale=16 ** -0.5))


def test_kernel_launcher_refuses_cpu_tensors_and_bad_shapes():
    (_, _, _), (q, k, v) = _both(_inputs(1, 16, 4, 2, 16, 2), "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        fak.flash_attention_kernel(q, k, v, scale=0.25)
    with pytest.raises(ValueError, match="multiple of K"):
        tops.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 16),
                             v[:, :, :1].expand(1, 16, 3, 16), scale=0.25)
    wide = torch.zeros(1, 4, 2, 260)
    with pytest.raises(ValueError, match="head widths"):
        tops.flash_attention(wide, wide, wide, scale=0.125)


def test_wrapper_hands_strided_operands_to_the_kernel_uncopied(monkeypatch):
    """Off the CPU (here ``meta`` tensors: this machine has no card) the
    wrapper launches the kernel on the views it was given, which the
    kernel reads through their strides, and counts the launch; the
    kernel launcher itself is replaced by a recorder."""
    qb = torch.zeros(2, 14, 30, 64, device="meta")
    kb = torch.zeros(2, 2, 30, 64, device="meta")
    q, k, v = qb.transpose(1, 2), kb.transpose(1, 2), kb.transpose(1, 2)
    seen = []

    def record(*tensors, scale, causal, semantics, window):
        assert semantics == "pallas"            # the wrapper's default
        assert window is None
        seen.append([(t.data_ptr(), t.stride()) for t in tensors])
        return torch.empty(q.shape, device="meta")

    monkeypatch.setattr(fak, "flash_attention_kernel", record)
    monkeypatch.setattr(tops.flash_attention, "launches", 0)
    tops.flash_attention(q, k, v, scale=0.125)
    assert seen == [[(t.data_ptr(), t.stride()) for t in (q, k, v)]]
    assert not q.is_contiguous()
    assert tops.flash_attention.launches == 1
