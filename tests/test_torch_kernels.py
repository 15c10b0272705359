"""Port parity: the crossbar forward kernel's plain version (the CPU path of
``repro_torch.kernels.ops``) against the reference's Pallas kernel, run in
interpret mode on CPU as ``tests/test_kernels.py`` runs it.

fp32 values agree within 1e-5 (the repo's kernel bar: the two sides sum in
different orders).  With the fused 3-bit ADC the outputs compare as integer
codes; a code may differ only where the value before the ADC lies within
1e-6 of a half-step boundary, and the tests that allow it say so.  The CUDA
kernel itself runs only on the card (``chip_smoke.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import crossbar as xbk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATOL = 1e-5
BOUNDARY = 1e-6
SCALE3 = 1.0 / 7                       # 3-bit ADC step on [-0.5, 0.5]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [(8, 4, 3), (16, 100, 50), (128, 700, 260), (64, 512, 128),
          (32, 1024, 256), (8, 401, 101)]   # tests/test_kernels.py


def _draw(seed, x_shape, g_shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(x_shape) * 0.3).astype(np.float32)
    gp = rng.uniform(0, 1, g_shape).astype(np.float32)
    gm = rng.uniform(0, 1, g_shape).astype(np.float32)
    return x, gp, gm


def _both(fn_j, fn_t, *arrays, **kw):
    ref = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, ref


def _assert_adc_codes(got, ref, pre):
    """3-bit codes equal except next to a half-step boundary of ``pre``."""
    codes = lambda a: np.rint((a + 0.5) / SCALE3)  # noqa: E731
    u = (np.clip(pre, -0.5, 0.5) + 0.5) / SCALE3
    diff = codes(got) != codes(ref)
    near = np.abs(u - np.floor(u) - 0.5) * SCALE3 < BOUNDARY
    assert not np.any(diff & ~near)
    np.testing.assert_allclose(got[~diff], ref[~diff], atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("activation", [True, False])
def test_crossbar_fwd_matches_pallas(shape, activation):
    M, K, N = shape
    x, gp, gm = _draw(K + N, (M, K), (K, N))
    got, ref = _both(jops.crossbar_fwd, tops.crossbar_fwd, x, gp, gm,
                     activation=activation)
    assert got.shape == (M, N) and got.dtype == np.float32
    # K up to 1024 of products ~0.3: absolute sums reach tens, so the
    # no-activation case is held at the repo's relative kernel bar too
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("shape", [(16, 100, 50), (8, 401, 101)])
def test_crossbar_fwd_fused_adc_matches_pallas(shape):
    M, K, N = shape
    x, gp, gm = _draw(7, (M, K), (K, N))
    x *= 0.05                            # keep h() inside its linear range
    got, ref = _both(jops.crossbar_fwd, tops.crossbar_fwd, x, gp, gm,
                     activation=True, adc_bits=3)
    pre = np.clip((x @ (gp - gm)) * 0.25, -0.5, 0.5)
    # codes may differ only next to a half-step boundary (module doc)
    _assert_adc_codes(got, ref, pre)


def test_crossbar_fwd_leading_axes_and_ref_oracle():
    x, gp, gm = _draw(3, (2, 5, 37), (37, 11))
    got, ref = _both(jops.crossbar_fwd, tops.crossbar_fwd, x, gp, gm)
    assert got.shape == (2, 5, 11)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(
        tref.crossbar_fwd_ref(*map(torch.from_numpy, (x, gp, gm))).numpy(),
        ref, atol=ATOL)




@pytest.mark.parametrize("x_shape,g_shape", [
    ((5, 3, 37), (5, 37, 11)),               # test_chip_sim.py ragged case
    ((2, 3, 7, 45), (2, 3, 45, 13)),         # leading chip axis (C, T, ...)
    ((6, 4, 400), (6, 400, 100)),            # mnist stage 0 geometry
    ((3, 4, 200), (3, 200, 100)),            # its aggregation stage
])
@pytest.mark.parametrize("activation", [False, True])
def test_crossbar_fwd_stacked_matches_pallas(x_shape, g_shape, activation):
    x, gp, gm = _draw(len(x_shape) + x_shape[-1], x_shape, g_shape)
    got, ref = _both(jops.crossbar_fwd_stacked, tops.crossbar_fwd_stacked,
                     x, gp, gm, activation=activation)
    assert got.shape == x_shape[:-1] + g_shape[-1:]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_crossbar_fwd_stacked_fused_adc_matches_pallas():
    x, gp, gm = _draw(11, (2, 3, 6, 45), (2, 3, 45, 13))
    x *= 0.1
    got, ref = _both(jops.crossbar_fwd_stacked, tops.crossbar_fwd_stacked,
                     x, gp, gm, activation=True, adc_bits=3)
    pre = np.clip(np.einsum("ctmk,ctkn->ctmn", x, gp - gm) * 0.25, -0.5, 0.5)
    # codes may differ only next to a half-step boundary (module doc)
    _assert_adc_codes(got, ref, pre)


def test_stacked_rejects_mixed_ranks():
    x = torch.zeros(2, 3, 4, 5)
    g = torch.zeros(3, 5, 2)
    with pytest.raises(ValueError):
        tops.crossbar_fwd_stacked(x, g, g)


def test_cpu_path_counts_no_launch():
    before = (tops.crossbar_fwd.launches, tops.crossbar_fwd_stacked.launches)
    x, gp, gm = map(torch.from_numpy, _draw(1, (2, 3, 8), (2, 8, 4)))
    tops.crossbar_fwd_stacked(x, gp, gm)
    tops.crossbar_fwd(x[0], gp[0], gm[0])
    assert (tops.crossbar_fwd.launches,
            tops.crossbar_fwd_stacked.launches) == before


def test_kernel_launcher_refuses_cpu_tensors():
    # the launcher never falls back: a tensor it cannot launch on raises
    x, gp, gm = map(torch.from_numpy, _draw(2, (1, 3, 8), (1, 8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        xbk.crossbar_fwd_kernel(x, gp, gm)


def test_kernel_modules_import_without_nvcc_or_card():
    code = ("import torch\n"
            "from repro_torch.kernels import _build, crossbar, ops, ref\n"
            "assert _build.load.cache_info().currsize == 0\n"
            "assert not torch.cuda.is_available()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), PATH="",
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
