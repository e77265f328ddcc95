"""Image / uncertainty metrics; counterpart of cfnerf_tpu/ops/metrics.py.

img2mse / mse2psnr (reference run_nerf_helpers.py:15-17) and the per-pixel
std-over-K map.  AUSE and SSIM come with the eval-CLI slice.
"""
from __future__ import annotations

import math

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x) / math.log(10.0)


def std_over_k(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-pixel std over the K draws in the reference's MAP convention:
    population std (ddof=0) scaled by n/(n-1)
    (run_nerf_uncertainty_NF.py:1129-1131).  The training bandwidth uses
    ddof=1 instead; this is not it.  K=1 gives zeros."""
    n = x.shape[dim]
    if n <= 1:
        return torch.zeros_like(x.select(dim, 0))
    return torch.std(x, dim=dim, correction=0) * n / (n - 1)
