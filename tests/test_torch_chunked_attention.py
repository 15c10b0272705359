"""Port parity: the LM prefill's attention, ``chunked_attention``.

The port's ``repro_torch.layers.attention.chunked_attention`` and its plain
``"chunked"`` function (``kernels.flash_attention.chunked_attention_plain``)
against the reference's ``repro.layers.attention.chunked_attention`` on
the same numpy inputs, at the flash tests' eight shapes and at kv chunks
of 32 (the reduced configs') and 512 (the full configs'); the repaired
fault (the port's prefill used to compute the Pallas kernel's function);
and the wrapper's refusals.

Tolerances:
- fp32: 2e-5 absolute plus 2e-5 relative, the reference's own kernel bar
  (the sides sum in different orders).
- bf16: one bf16 step plus 2^-7 max_j p_j |v_j| / l, |a - b| <= spacing
  of bf16 at max(|a|, |b|) + 1e-6 + 2^-7 max_j p_j |v_j| / l.  Both sides
  take q . k and p . v from exact fp32 products, round p to bf16 against
  the same running max, and round the output once; but their fp32 scores
  sum in other orders and may differ in the last bit, and a p_j at a bf16
  rounding boundary then rounds one bf16 step (at most 2^-7 p_j) apart,
  which moves the output by at most 2^-7 p_j |v_j| / l.  Measured on the
  CPU: 27 of 1.2 M outputs (three seeds, every case below) lie past one
  bf16 step, the largest by 0.0036 max_j p_j |v_j| / l (a 2.1x margin
  under 2^-7); the old path (the Pallas function) puts 1,473 outputs past
  the whole bar, and fails it at every shape of
  ``test_the_old_prefill_path_was_further_from_chunked_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.layers.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402

TOL = 2e-5
# (B, S, H, K, hd, causal): tests/test_torch_flash_attention.py's SHAPES
SHAPES = [
    (2, 64, 4, 2, 16, True), (1, 128, 2, 1, 32, True),
    (2, 64, 4, 4, 16, False), (1, 256, 2, 2, 64, True),
    (1, 96, 4, 2, 16, True), (2, 200, 2, 1, 32, True),
    (1, 128, 14, 2, 64, True), (1, 200, 4, 2, 16, False),
]


def _inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, K, hd), np.float32),
            rng.standard_normal((B, S, K, hd), np.float32))


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the same values in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def max_weighted_term(q, k, v, scale, causal) -> np.ndarray:
    """max_j p_j |v_j| / l of each output in fp32, p the plain softmax."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          fak.NEG_INF)
    p = torch.softmax(s, dim=-1)                        # (B, K, G, S, S)
    va = v.float().abs().permute(0, 2, 1, 3)[:, :, None, None]
    t = (p[..., None] * va).amax(dim=-2)                # (B, K, G, S, hd)
    return _f32(t.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd))


def past_the_bar(got, want, q, k, v, scale, causal) -> np.ndarray:
    """The outputs of ``got`` past the bf16 bar (module docstring)."""
    excess = past_one_step(got, want)
    return excess > 2.0 ** -7 * max_weighted_term(q, k, v, scale, causal)


def past_one_step(got, want) -> np.ndarray:
    """|got - want| beyond one bf16 step at the larger magnitude + 1e-6."""
    got, want = _f32(got), _f32(want)
    bar = bf16_step(np.maximum(np.abs(got), np.abs(want))) + 1e-6
    return np.abs(got - want) - bar


J_CHUNKED = jax.jit(j_chunked, static_argnames=(
    "scale", "causal", "window", "q_chunk", "kv_chunk"))
# (shape, chunk): every SHAPES row at chunk 512, and at 32 where 32
# divides S (the reference asserts that its chunks divide S)
CASES = [(shape, chunk) for shape in SHAPES for chunk in (32, 512)
         if chunk == 512 or shape[1] % chunk == 0]


def _reference(jq, jk, jv, hd, causal, chunk):
    return J_CHUNKED(jq, jk, jv, scale=hd ** -0.5, causal=causal,
                     window=None, q_chunk=chunk, kv_chunk=chunk)


def _assert_close(got, want, dtype, what, q, k, v, scale, causal):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL,
                                   rtol=TOL, err_msg=str(what))
    else:
        past = past_the_bar(got, want, q, k, v, scale, causal)
        assert not past.any(), (what, int(past.sum()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk", CASES)
def test_chunked_plain_matches_the_reference(shape, chunk, dtype):
    B, S, H, K, hd, causal = shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, H, K, hd, S + chunk),
                                    dtype)
    want = _reference(jq, jk, jv, hd, causal, chunk)
    got = fak.chunked_attention_plain(q, k, v, scale=hd ** -0.5,
                                      causal=causal, q_chunk=chunk,
                                      kv_chunk=chunk)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    _assert_close(got, want, dtype, (shape, chunk), q, k, v, hd ** -0.5,
                  causal)
    # the layer's function on CPU tensors is that plain version
    layer = tattn.chunked_attention(q, k, v, scale=hd ** -0.5,
                                    causal=causal, window=None,
                                    q_chunk=chunk, kv_chunk=chunk)
    assert torch.equal(layer, got)


@pytest.mark.parametrize("shape", [(1, 128, 14, 2, 64, True),
                                   (2, 64, 4, 2, 16, True),
                                   (1, 256, 2, 2, 64, True)])
def test_the_old_prefill_path_was_further_from_chunked_attention(shape):
    """The repaired fault: the port's bf16 prefill used to compute the
    Pallas kernel's function (q scaled before the product, p in fp32),
    which misses the reference's prefill by more than one bf16 step at
    thousands of outputs and fails the bf16 bar of the parity tests; the
    ``"chunked"`` function, on the same inputs, passes it and lies past
    one step at a hundredth as many outputs (p rounding one step apart
    where the two sides' fp32 scores differ in the last bit)."""
    B, S, H, K, hd, causal = shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, H, K, hd, 5), "bfloat16")
    want = _f32(_reference(jq, jk, jv, hd, causal, 32))
    old = _f32(tops.flash_attention(q, k, v, scale=hd ** -0.5,
                                    causal=causal))
    new = _f32(tattn.chunked_attention(q, k, v, scale=hd ** -0.5,
                                       causal=causal, window=None,
                                       q_chunk=32, kv_chunk=32))
    old_past, new_past = past_one_step(old, want), past_one_step(new, want)
    assert (old_past > 0).sum() > 100 * max((new_past > 0).sum(), 1)
    scale = hd ** -0.5
    assert past_the_bar(old, want, q, k, v, scale, causal).any()
    assert not past_the_bar(new, want, q, k, v, scale, causal).any()
    assert np.abs(new - want).max() < np.abs(old - want).max()
    assert (new != want).sum() < (old != want).sum() / 10


def test_ops_chunked_semantics_on_cpu_is_the_plain_version_uncounted():
    (_, _, _), (q, k, v) = _both(_inputs(1, 96, 4, 2, 16, 8), "bfloat16")
    before = tops.flash_attention.launches
    routes = dict(fak.flash_attention_kernel.routes)
    got = tops.flash_attention(q, k, v, scale=0.25, semantics="chunked")
    assert tops.flash_attention.launches == before
    assert fak.flash_attention_kernel.routes == routes
    # the reference's default 512 x 512 chunks, or the chunks passed
    assert torch.equal(got, fak.chunked_attention_plain(q, k, v, scale=0.25))
    assert torch.equal(
        tops.flash_attention(q, k, v, scale=0.25, semantics="chunked",
                             q_chunk=32, kv_chunk=32),
        fak.chunked_attention_plain(q, k, v, scale=0.25, q_chunk=32,
                                    kv_chunk=32))
    assert not torch.equal(got, tops.flash_attention(q, k, v, scale=0.25))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skip_masked_blocks_and_past_diagonal_chunks_change_nothing(dtype):
    """Fully masked blocks give p = 0 and corr = 1 exactly: the plain
    version skips them, and ``skip_masked_blocks`` is accepted as a
    schedule flag only."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 128, 4, 2, 16, 9), dtype)
    kw = dict(scale=0.25, causal=True, window=None, q_chunk=32, kv_chunk=32)
    a = tattn.chunked_attention(q, k, v, **kw)
    b = tattn.chunked_attention(q, k, v, **kw, skip_masked_blocks=True)
    assert torch.equal(a, b)
    # the reference's skipped schedule gives the same numbers as its dense
    want = J_CHUNKED(jq, jk, jv, **kw)
    _assert_close(a, want, dtype, "skip_masked_blocks", q, k, v, 0.25, True)


def test_unported_chunked_attention_raises():
    """Nothing of ``chunked_attention`` is refused any more: windows
    (tests/test_torch_hybrid.py) and cross-attention, non-causal at Sq !=
    Skv, which matches the reference's (tests/test_torch_encdec.py holds
    it at more shapes and in bf16)."""
    x = torch.zeros(1, 16, 2, 16)
    kw = dict(scale=0.25, q_chunk=8, kv_chunk=8)
    assert tattn.chunked_attention(x, x, x, causal=True, window=4,
                                   **kw).shape == x.shape
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 16, 2, 2, 16, 3), "float32")
    got = tattn.chunked_attention(q, k[:, :8], v[:, :8], causal=False,
                                  window=None, **kw)
    want = J_CHUNKED(jq, jk[:, :8], jv[:, :8], causal=False, window=None,
                     **kw)
    assert got.shape == (1, 16, 2, 16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL, rtol=TOL)
    # causal with Sq != Skv keeps the mask counted from 0 on both sides
    got = tattn.chunked_attention(x, x[:, :8], x[:, :8], causal=True,
                                  window=None, **kw)
    assert got.shape == x.shape


def test_prefill_runs_chunked_attention_at_the_layer_chunks(monkeypatch):
    """``attention_apply``'s prefill hands its config's scale and chunks to
    ``chunked_attention`` (512/512 at full width, 32/32 reduced)."""
    from repro_torch.configs import base as tcfg
    assert (tcfg.get_config("qwen2-0.5b").attn().q_chunk,
            tcfg.get_config("qwen2-0.5b").attn().kv_chunk) == (512, 512)
    cfg = tcfg.get_reduced_config("qwen2-0.5b").attn()
    assert (cfg.q_chunk, cfg.kv_chunk) == (32, 32)
    seen = []
    plain = fak.chunked_attention_plain

    def record(q, k, v, **kw):
        seen.append(kw)
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fak, "chunked_attention_plain", record)
    gen = torch.Generator().manual_seed(0)
    params = tshd.init_params(gen, tattn.attention_spec(cfg))
    x = torch.randn(2, 64, cfg.d_model, generator=gen)
    pos = torch.arange(64).expand(2, 64)
    tattn.attention_apply(params, x, cfg, positions=pos,
                          compute_dtype=torch.float32)
    assert seen == [dict(scale=cfg.scale, causal=True, q_chunk=32,
                         kv_chunk=32, window=None)]


def test_semantics_and_head_widths_the_kernels_do_not_take_raise():
    (_, _, _), (q, k, v) = _both(_inputs(1, 16, 4, 2, 16, 2), "bfloat16")
    for fn in (tops.flash_attention, fak.flash_attention_kernel):
        with pytest.raises(ValueError, match="semantics must be one of"):
            fn(q, k, v, scale=0.25, semantics="flash")
    # bf16 goes to the tensor-core kernel: hd 16, 32, 64, 128 or 256 only, and
    # the wrapper says so before it looks for a card
    odd = torch.zeros(1, 16, 4, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core flash kernel takes"):
        fak.flash_attention_kernel(odd, odd[:, :, :2], odd[:, :, :2],
                                   scale=0.125)
    # fp32 goes to the CUDA-core kernel, which takes any hd <= 256
    with pytest.raises(ValueError, match="CUDA device"):
        fak.flash_attention_kernel(odd.float(), odd[:, :, :2].float(),
                                   odd[:, :, :2].float(), scale=0.125)
    assert fak.route(torch.bfloat16) == "wgmma"
    assert fak.route(torch.float32) == "simt"


def test_the_tensor_core_wrapper_copies_only_unaligned_rows():
    """The bf16 kernel copies 16-byte rows asynchronously: a view is
    handed over as it is when its inner stride is 1 and its start and
    other strides are 16-byte aligned, and copied contiguous otherwise."""
    buf = torch.zeros(2, 14, 30, 64, dtype=torch.bfloat16)
    assert fak._rows_aligned(buf)
    assert fak._rows_aligned(buf.transpose(1, 2))       # (B, S, H, hd) view
    wide = torch.zeros(2, 30, 2, 68, dtype=torch.bfloat16)
    assert not fak._rows_aligned(wide[..., :64])         # heads 136 B apart
    assert not fak._rows_aligned(buf[..., 1:33])         # start off by 2 B
    assert not fak._rows_aligned(buf.transpose(2, 3))    # inner stride 30
