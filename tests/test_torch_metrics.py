"""The port's remaining metrics (cfnerf_torch/ops/metrics.py: to8b, the AUSE
sparsification curves, SSIM; cfnerf_torch/cli/eval.py: kde_nll_per_pixel)
against the JAX package's on the same numpy inputs.  skimage is not
installed, so JAX's own ssim is the oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.cli.eval import kde_nll_per_pixel as jax_kde_nll_per_pixel
from cfnerf_tpu.ops import metrics as jm
from cfnerf_torch.cli.eval import kde_nll_per_pixel
from cfnerf_torch.ops import metrics as tm

# f32 sums of the windowed moments run in another order in XLA's and
# PyTorch's convolutions; a flat white image is the ill-conditioned case
SSIM_ATOL = 1e-6
KDE_RTOL = 1e-6


def _vectors(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    if kind == "ties":  # few distinct values: argsort order among ties matters
        return (rng.randint(0, 4, n) / 4.0).astype(np.float32), \
            (rng.randint(0, 3, n) / 3.0).astype(np.float32)
    if kind == "zero_var":
        return np.zeros(n, np.float32), rng.rand(n).astype(np.float32)
    raise ValueError(kind)


def test_to8b_bitwise():
    x = np.random.RandomState(0).randn(64, 48, 3).astype(np.float32)
    np.testing.assert_array_equal(tm.to8b(x), jm.to8b(x))
    assert tm.to8b(x).dtype == np.uint8


@pytest.mark.parametrize("kind", ["random", "ties", "zero_var"])
@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000])
@pytest.mark.parametrize("uncert_type,err_type", [("c", "rmse"), ("c", "mse"), ("v", "rmse")])
def test_sparsification_and_ause_bitwise(kind, n, uncert_type, err_type):
    var, err = _vectors(kind, n, seed=n)
    got = tm.sparsification_plot(var, err, uncert_type, err_type)
    want = jm.sparsification_plot(var, err, uncert_type, err_type)
    for g, w in zip(got, want):
        assert g.shape == (100,)
        np.testing.assert_array_equal(g, w)
    assert tm.ause(var, err, err_type) == jm.ause(var, err, err_type)


def _ssim_pair(a, b):
    got = float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jm.ssim(jnp.asarray(a), jnp.asarray(b)))
    return got, want


@pytest.mark.parametrize("H,W", [(20, 30), (11, 11), (8, 8), (4, 4)])
def test_ssim_random_pairs(H, W):
    rng = np.random.RandomState(H * W)
    a = rng.rand(H, W, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(H, W, 3), 0, 1).astype(np.float32)
    got, want = _ssim_pair(a, b)
    assert abs(got - want) <= SSIM_ATOL, (got, want)


def test_ssim_identical_images_is_one():
    a = np.random.RandomState(1).rand(16, 24, 3).astype(np.float32)
    got, want = _ssim_pair(a, a.copy())
    assert abs(got - want) <= SSIM_ATOL and abs(got - 1.0) <= SSIM_ATOL


def test_ssim_flat_white_background():
    # flat white: blur(x*x) - mu^2 cancels to rounding noise, which the
    # clamps hold at >= 0 (and the map at <= 1)
    a = np.ones((24, 24, 3), np.float32)
    got, want = _ssim_pair(a, a.copy())
    assert abs(got - want) <= SSIM_ATOL and got <= 1.0 and abs(got - 1.0) <= SSIM_ATOL


def test_ssim_near_white_is_rounding_bound():
    # Near-white images with small differences: each window's variance lies
    # below an f32 ulp of 1, so blur(x*x) - mu^2 is rounding noise in both
    # implementations and their XLA / PyTorch convolution orders differ
    # (measured 1.3e-6 for an object on white, 1.7e-4 for white minus
    # U(0, 1e-3) noise).  Held here: both stay <= 1 and near each other.
    a = np.ones((24, 24, 3), np.float32)
    a[8:14, 9:15] = 0.3
    b = a.copy()
    b[8:14, 9:15] += 0.01
    noisy = (1.0 - np.random.RandomState(0).rand(24, 24, 3) * 1e-3).astype(np.float32)
    for x, y in ((a, b), (np.ones_like(noisy), noisy)):
        got, want = _ssim_pair(x, y)
        assert got <= 1.0 and want <= 1.0
        assert abs(got - want) <= 1e-3, (got, want)


def test_ssim_window_larger_in_one_dimension_raises_as_jax():
    a = np.zeros((8, 20, 3), np.float32)
    with pytest.raises(ValueError):
        jm.ssim(jnp.asarray(a), jnp.asarray(a))
    with pytest.raises(ValueError):
        tm.ssim(torch.from_numpy(a), torch.from_numpy(a))


@pytest.mark.parametrize("k", [2, 4, 32])
def test_kde_nll_per_pixel(k):
    rng = np.random.RandomState(k)
    rgb_k = rng.rand(6, 5, 3, k).astype(np.float32)
    gt = rng.rand(6, 5, 3).astype(np.float32)
    got = kde_nll_per_pixel(rgb_k, gt, k)
    want = jax_kde_nll_per_pixel(rgb_k, gt, k)
    assert got.shape == (6, 5, 3)
    np.testing.assert_allclose(got, want, rtol=KDE_RTOL, atol=0)
