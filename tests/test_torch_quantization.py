"""Port parity: repro_torch.core.quantization against repro.core.quantization.

Inputs are drawn with numpy from a seed and fed to both packages.  Values
compare exactly or as integer codes; a code may differ only where the value
before rounding lies within 1e-6 of a half-step boundary (the two sides may
divide by the step differently in the last bit), and each test that allows
it says so.  Exact half-step inputs use steps that are powers of two, so
they exercise half-to-even rounding with no division error at all.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as jq  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402

BOUNDARY = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _assert_codes(port_codes, ref_codes, u, scale):
    """Integer codes equal, except where ``u`` (the value before rounding,
    in steps) lies within BOUNDARY of a half step."""
    port_codes, ref_codes = np.asarray(port_codes), np.asarray(ref_codes)
    diff = port_codes != ref_codes
    near = np.abs(u - np.floor(u) - 0.5) * scale < BOUNDARY
    assert not np.any(diff & ~near), np.argwhere(diff & ~near)[:5]


@pytest.mark.parametrize("bits,rng_range", [(3, 0.5), (2, 0.5), (5, 1.0)])
def test_adc_quantize_codes_match(bits, rng_range):
    x = np.random.default_rng(bits).uniform(-0.8, 0.8, (64, 37)) \
        .astype(np.float32)
    ref = np.asarray(jq.adc_quantize(jnp.asarray(x), bits,
                                     rng_range=rng_range))
    got = tq.adc_quantize(_t(x), bits, rng_range=rng_range).numpy()
    scale = 2 * rng_range / (2 ** bits - 1)
    codes = lambda a: np.rint((a + rng_range) / scale)  # noqa: E731
    # codes may differ only next to a half-step boundary (see module doc)
    u = (np.clip(x, -rng_range, rng_range) + rng_range) / scale
    _assert_codes(codes(got), codes(ref), u, scale)
    same = codes(got) == codes(ref)
    np.testing.assert_array_equal(got[same], ref[same])


def test_adc_quantize_half_steps_round_to_even():
    # rng_range 3.5 at 3 bits: step 1.0, so integer inputs sit exactly on
    # half steps of (x + 3.5); halves must go to the even code.
    x = np.arange(-3, 4, dtype=np.float32)
    ref = np.asarray(jq.adc_quantize(jnp.asarray(x), 3, rng_range=3.5))
    got = tq.adc_quantize(_t(x), 3, rng_range=3.5).numpy()
    np.testing.assert_array_equal(got, ref)
    codes = got + 3.5
    assert np.all(codes % 2 == 0), codes           # half-to-even
    # at one bit on [-0.5, 0.5] the step is 1 and 0 is a half step
    z = np.zeros(3, np.float32)
    np.testing.assert_array_equal(
        tq.adc_quantize(_t(z), 1).numpy(),
        np.asarray(jq.adc_quantize(jnp.asarray(z), 1)))


def test_adc_quantize_ste_values_and_gradient():
    x = np.random.default_rng(1).uniform(-0.6, 0.6, (8, 13)) \
        .astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = tq.adc_quantize_ste(xt)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jq.adc_quantize_ste(jnp.asarray(x))))
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


@pytest.mark.parametrize("block_axis", [None, 0, 1])
def test_error_quantize_codes_and_scale(block_axis):
    x = (np.random.default_rng(3).standard_normal((16, 24)) * 0.05) \
        .astype(np.float32)
    x[2] = 0.0                                     # an all-zero row
    ref = jq.error_quantize(jnp.asarray(x), block_axis=block_axis)
    got = tq.error_quantize(_t(x), block_axis=block_axis)
    assert got.codes.dtype == torch.int8 and got.bits == ref.bits == 8
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    u = np.abs(x) / np.asarray(ref.scale)
    # codes may differ only next to a half-step boundary (see module doc)
    _assert_codes(got.codes.numpy(), np.asarray(ref.codes), u,
                  np.asarray(ref.scale))
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(ref.dequantize()), atol=1e-7)


def test_error_quantize_half_steps_and_wide_codes():
    # max |x| = 127 gives scale 1.0: x.5 magnitudes are exact half steps
    x = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 0.0], np.float32)
    ref = jq.error_quantize(jnp.asarray(x))
    got = tq.error_quantize(_t(x))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.codes.numpy(),
                                  [127, 2, -4, 0, 0, 2, 0])
    wide = tq.error_quantize(_t(x), bits=12)
    assert wide.codes.dtype == torch.int32
    np.testing.assert_array_equal(
        wide.codes.numpy(),
        np.asarray(jq.error_quantize(jnp.asarray(x), bits=12).codes))


def test_error_quantize_ste_values():
    x = (np.random.default_rng(4).standard_normal((6, 9)) * 0.1) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tq.error_quantize_ste(_t(x)).numpy(),
        np.asarray(jq.error_quantize_ste(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_matches(axis):
    x = np.random.default_rng(5).standard_normal((10, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tq.fake_quant(_t(x), 4, per_channel_axis=axis).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(x), 4, per_channel_axis=axis)),
        atol=1e-6)
    halves = np.array([127.0, 2.5, -3.5, 0.5], np.float32)   # scale 1.0
    np.testing.assert_array_equal(
        tq.fake_quant(_t(halves), 8).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(halves), 8)))


def test_pulse_discretize_matches_with_half_steps():
    unit = 1.0 / 128                                # max_dw 1.0, 128 levels
    rng = np.random.default_rng(6)
    dw = np.concatenate([
        (np.arange(-6, 6) + 0.5) * unit,            # exact half pulses
        rng.uniform(-1.5, 1.5, 200),                # clipped beyond +-128
    ]).astype(np.float32)
    ref = np.asarray(jq.pulse_discretize(jnp.asarray(dw), 1.0, 128))
    got = tq.pulse_discretize(_t(dw), 1.0, 128).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:12] / unit,
                                  [-6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6])
    # the paper's budget: 0.05 over 128 levels (unit not a power of two)
    small = (rng.standard_normal(300) * 0.02).astype(np.float32)
    u = small / (0.05 / 128)
    ref = np.asarray(jq.pulse_discretize(jnp.asarray(small), 0.05))
    got = tq.pulse_discretize(_t(small), 0.05).numpy()
    # codes may differ only next to a half-step boundary (see module doc)
    _assert_codes(np.rint(got / (0.05 / 128)), np.rint(ref / (0.05 / 128)),
                  np.abs(u), 0.05 / 128)


def test_stochastic_rounding_is_unbiased_with_a_generator():
    # the port draws from a torch.Generator (not jax.random): hold it to
    # the reference's contract — floor or ceil, unbiased in expectation
    x = torch.full((20000,), 0.3)
    gen = torch.Generator().manual_seed(0)
    q = tq.pulse_discretize(x, 1.0, 1, generator=gen)
    assert set(np.unique(q.numpy())) <= {0.0, 1.0}
    assert abs(float(q.mean()) - 0.3) < 0.02
    gen2 = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        q.numpy(), tq.pulse_discretize(x, 1.0, 1, generator=gen2).numpy())
    e = tq.error_quantize(torch.tensor([127.0, 0.4] * 5000),
                          generator=torch.Generator().manual_seed(1))
    assert abs(float(e.codes[1::2].float().mean()) - 0.4) < 0.03
    a = tq.adc_quantize(torch.zeros(5000), 3,
                        generator=torch.Generator().manual_seed(2))
    assert set(np.round((a.numpy() + 0.5) * 7).astype(int)) <= {3, 4}
