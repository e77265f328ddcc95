"""Image / uncertainty metrics; counterpart of cfnerf_tpu/ops/metrics.py.

  * img2mse / mse2psnr / to8b (reference run_nerf_helpers.py:15-17) and the
    per-pixel std-over-K map;
  * the AUSE sparsification curves (run_nerf_helpers.py:382-438), host
    numpy, copied from the JAX package;
  * SSIM of the mean image: JAX's own Gaussian-windowed implementation (the
    reference imports skimage's but never calls it), in PyTorch.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x) / math.log(10.0)


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def std_over_k(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-pixel std over the K draws in the reference's MAP convention:
    population std (ddof=0) scaled by n/(n-1)
    (run_nerf_uncertainty_NF.py:1129-1131).  The training bandwidth uses
    ddof=1 instead; this is not it.  K=1 gives zeros."""
    n = x.shape[dim]
    if n <= 1:
        return torch.zeros_like(x.select(dim, 0))
    return torch.std(x, dim=dim, correction=0) * n / (n - 1)


def sparsification_plot(
    var_vec: np.ndarray,
    err_vec: np.ndarray,
    uncert_type: str = "c",
    err_type: str = "rmse",
) -> Tuple[np.ndarray, np.ndarray]:
    """AUSE sparsification curves.  For each removal ratio r in [0, 1) (100
    steps): the error over the (1 - r) share of pixels kept when removing the
    highest-error pixels (the oracle curve) and the highest-variance pixels
    (uncert_type "c"; otherwise the lowest).  At least one pixel is always
    kept.  Returns (oracle, by_variance)."""
    var_vec = np.asarray(var_vec).reshape(-1)
    err_vec = np.asarray(err_vec).reshape(-1)
    ratio_removed = np.linspace(0, 1, 100, endpoint=False)
    n = len(err_vec)

    def curve(err_ordered):
        out = []
        for r in ratio_removed:
            sl = err_ordered[: max(1, int((1 - r) * n))]  # keep >= 1 pixel
            out.append(np.sqrt(sl.mean()) if err_type == "rmse" else sl.mean())
        return np.array(out)

    std_vec = np.sqrt(var_vec)
    order = np.argsort(-std_vec) if uncert_type == "c" else np.argsort(std_vec)
    return curve(np.sort(err_vec)), curve(err_vec[order])


def ause(var_vec: np.ndarray, err_vec: np.ndarray, err_type: str = "rmse") -> float:
    """Scalar AUSE: the mean gap between the by-variance and oracle curves."""
    oracle, by_var = sparsification_plot(var_vec, err_vec, "c", err_type)
    return float(np.mean(by_var - oracle))


def _gaussian_kernel(size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(
    img0: torch.Tensor,
    img1: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity of two (H, W, C) images: the moments under a
    filter_size^2 Gaussian window (a 'valid' 2-D convolution per channel),
    the variances clamped at 0 and the covariance to +-sqrt(s00 s11) so that
    the map stays <= 1 where f32 cancellation would push it past 1 (flat
    white background), then the mean of the map.  A 0-dim tensor on the
    images' device.

    The convolution is jax.scipy.signal.convolve2d's 'valid' mode: an image
    smaller than the window in both dimensions swaps the two (the window
    convolved by the image), one smaller in a single dimension raises
    ValueError."""
    k = _gaussian_kernel(filter_size, filter_sigma)
    window = torch.outer(k, k).to(img0.device)
    H, W = img0.shape[:2]
    swap = H < filter_size and W < filter_size
    if not swap and (H < filter_size or W < filter_size):
        raise ValueError("One input must be smaller than the other in every dimension.")

    def blur(im):
        chans = im.permute(2, 0, 1)[:, None]  # (C, 1, H, W): each channel alone
        if swap:
            # the window as input, each flipped channel as a filter
            out = F.conv2d(window[None, None], torch.flip(chans, (2, 3)))[0]
        else:
            # a convolution is a correlation with the flipped (symmetric) window
            out = F.conv2d(chans, window[None, None])[:, 0]
        return out.permute(1, 2, 0)

    img0, img1 = img0.float(), img1.float()
    mu0, mu1 = blur(img0), blur(img1)
    s00 = torch.clamp(blur(img0 * img0) - mu0 ** 2, min=0.0)
    s11 = torch.clamp(blur(img1 * img1) - mu1 ** 2, min=0.0)
    s01 = blur(img0 * img1) - mu0 * mu1
    s01 = torch.sign(s01) * torch.minimum(torch.abs(s01), torch.sqrt(s00 * s11))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    )
    return torch.mean(ssim_map)
