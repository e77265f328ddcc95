"""CF-NeRF training losses; counterpart of cfnerf_tpu/train/loss.py
(reference loss block, run_nerf_uncertainty_NF.py:1026-1054).

  * KDE (Parzen-window) negative log-likelihood of the target pixel under
    the K rendered RGB samples, bandwidth
    H = std_detached * (0.8/n)^(-1/7) + 1e-5 (:1036), std being the
    Bessel-corrected sample std scaled by n/(n-1) (:1034);
  * beta1-weighted flow entropy (:1047-1048);
  * optional COLMAP depth MSE on the mean-over-K depth (:1019-1023,
    :1052-1054), unweighted as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from cfnerf_torch.ops.metrics import img2mse

KDE_EPS = 1e-5


def kde_nll(rgbs: torch.Tensor, target: torch.Tensor, k_samples: int) -> torch.Tensor:
    """-log mean_k N(target | rgb_k, H^2), averaged over rays and channels.

    rgbs (R, 3, K): K rendered RGB samples per ray; target (R, 3).  The
    bandwidth is detached: no gradient flows through the std."""
    n = k_samples
    rgb_std = torch.std(rgbs, dim=-1, correction=1) * n / (n - 1)  # (R, 3)
    h_sqrt = rgb_std.detach() * (0.8 / n) ** (-1.0 / 7.0) + KDE_EPS
    h_sqrt = h_sqrt[..., None]  # (R, 3, 1)
    kernel = torch.exp(-((rgbs - target[..., None]) ** 2) / (2.0 * h_sqrt * h_sqrt))
    norm = (2.0 * math.pi) ** (-1.5) / h_sqrt
    p = (kernel * norm).mean(-1) + KDE_EPS  # (R, 3)
    return -torch.log(p).mean()


def depth_loss(depth_k: torch.Tensor, target_depth: torch.Tensor) -> torch.Tensor:
    """MSE between the mean-over-K rendered depth and COLMAP sparse depth."""
    return img2mse(depth_k.mean(-1), target_depth)


def total_loss(
    rgbs: torch.Tensor,
    target: torch.Tensor,
    loss_entropy: torch.Tensor,
    *,
    k_samples: int,
    beta1: float = 0.0,
    depth_k: Optional[torch.Tensor] = None,
    target_depth: Optional[torch.Tensor] = None,
    depth_lambda: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = nll + beta1 * entropy (+ depth_lambda * depth mse).  beta1 = 0
    drops the entropy term, as the reference's truthiness check does
    (:1047)."""
    loss_nll = kde_nll(rgbs, target, k_samples)
    loss = loss_nll
    metrics = {"loss_nll": loss_nll, "loss_entropy": loss_entropy}
    if beta1:
        loss = loss + beta1 * loss_entropy
    if depth_k is not None and target_depth is not None:
        d = depth_loss(depth_k, target_depth)
        loss = loss + depth_lambda * d
        metrics["depth_loss"] = d
    metrics["loss"] = loss
    return loss, metrics
