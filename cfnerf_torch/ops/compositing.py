"""Alpha compositing over the K Monte-Carlo radiance draws; counterpart of
cfnerf_tpu/ops/compositing.py (reference raw2outputs,
run_nerf_uncertainty_NF.py:411-454).

CF-NeRF specifics kept:
  * sigma -> alpha through softplus: 1 - exp(-softplus(raw) * dist);
  * the last interval is 1e1 (10.0), not 1e10;
  * K trails every tensor: rgb_map (R, 3, K), disp/depth/acc (R, K),
    weights (R, S, K);
  * transmittance is the exclusive cumprod of (1 - alpha + 1e-10);
  * white background: rgb += (1 - acc);
  * the reference computes density noise and never adds it; that is kept
    (apply_noise=False), and apply_noise=True is the intended behaviour:
    N(0, 1) * raw_noise_std added to the density before the softplus.

This is the oracle side of the fused render core.  Its gradient flows
through cumprod, which is division-free (a closed-form VJP divides by
1 - alpha + eps and NaNs once alpha saturates).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cfnerf_torch.ops.sampling import per_ray

LAST_DIST = 1e1    # reference quirk: 10.0, not 1e10 (:427)
TRANS_EPS = 1e-10  # reference :443 (1 - alpha + 1e-10)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(-|x|)): jax.nn.softplus, with no threshold
    cut (torch.nn.functional.softplus switches to x above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


class _CumProd(torch.autograd.Function):
    """torch.cumprod(x, dim), its backward written out as the one torch
    takes for an input without zeros (FunctionsManual.cpp:cumprod_backward:
    the reversed cumsum of output * grad, over the input).  torch first reads
    back from the device whether the input holds a zero, a host read that
    a CUDA graph cannot capture (train/graph.py); the composite's input,
    1 - alpha + 1e-10, holds none, so the gradient is torch's, bit for
    bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        x, out = ctx.saved_tensors
        dim = ctx.dim
        if x.numel() <= 1 or x.shape[dim] == 1:
            return grad, None
        return (out * grad).flip(dim).cumsum(dim).flip(dim).div(x), None


def composite_weights(alpha: torch.Tensor) -> torch.Tensor:
    """weights_i = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10) over the sample
    axis (-2), K trailing."""
    trans = _CumProd.apply(1.0 - alpha + TRANS_EPS, -2)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-2)
    return alpha * trans


def finalize_k_maps(
    rgb_map: torch.Tensor, depth_map: torch.Tensor, acc_map: torch.Tensor,
    white_bkgd: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disparity + white-background blend on (R, [3,] K) composite outputs
    (reference :446-452), shared by raw2outputs and the fused path."""
    disp_map = 1.0 / torch.clamp(depth_map / (acc_map + 1e-10) + 1e-10, min=2e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[:, None, :])
    return rgb_map, disp_map


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    apply_noise: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite K radiance-field draws along each ray.

    Args:
      raw:    (R, S, K, 4): [..., :3] pre-sigmoid RGB, [..., 3] pre-softplus
              density.
      z_vals: (R, S) sample depths.
      rays_d: (R, 3) unnormalized ray directions.
      apply_noise, raw_noise_std: with both set, noise * raw_noise_std is
              added to the density, `noise` (R, S, K) standard normal draws
              when given (tests inject JAX's), else drawn from `generator` on
              its device; with neither there is no noise, as JAX's
              raw2outputs adds none without a key.

    Returns (rgb_map (R,3,K), disp_map (R,K), acc_map (R,K),
             weights (R,S,K), depth_map (R,K)).
    """
    raw = raw.to(torch.float32)
    z_vals = z_vals.to(torch.float32)

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], LAST_DIST)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)  # (R, S)

    rgb = torch.sigmoid(raw[..., :3])  # (R, S, K, 3)
    density = raw[..., 3]  # (R, S, K)
    if apply_noise and raw_noise_std > 0.0:
        if noise is None and generator is not None:
            noise = per_ray(lambda shape: torch.randn(
                shape, generator=generator, device=generator.device), density.shape
            ).to(density)
        if noise is not None:
            density = density + noise.to(density) * raw_noise_std
    alpha = 1.0 - torch.exp(-softplus(density) * dists[..., None])  # (R, S, K)
    weights = composite_weights(alpha)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-3).transpose(-1, -2)  # (R, 3, K)
    depth_map = torch.sum(weights * z_vals[..., None], dim=-2)  # (R, K)
    acc_map = torch.sum(weights, dim=-2)
    rgb_map, disp_map = finalize_k_maps(rgb_map, depth_map, acc_map, white_bkgd)
    return rgb_map, disp_map, acc_map, weights, depth_map
