"""Along-ray sample placement; counterpart of cfnerf_tpu/ops/sampling.py.

  * the hardcoded 96+32 non-uniform z schedule (reference
    run_nerf_uncertainty_NF.py:510-516);
  * stratified jitter (:518-532), drawn from an explicit torch.Generator;
  * sample_pdf, the inverse-CDF resampling of hierarchical sampling
    (nerf-pytorch semantics, cfnerf_tpu/ops/sampling.py:73-124);
  * per_ray / ray_rows: a draw with one row (or a block of rows) per ray,
    as a data-parallel rank takes it: under ray_rows the draw is made at
    the shape of every rank's rays together and this rank's rows are kept,
    so N ranks draw what one run over the whole batch draws.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

# (this rank's global row indices, the global ray count) while a data-
# parallel step renders; None elsewhere
_RAY_ROWS: contextvars.ContextVar = contextvars.ContextVar("ray_rows", default=None)


@contextlib.contextmanager
def ray_rows(index: torch.Tensor, n_global: int) -> Iterator[None]:
    """Within the block, per_ray draws are made for n_global rays and cut to
    the rows `index` (this rank's rays' places in the whole batch)."""
    token = _RAY_ROWS.set((index, int(n_global)))
    try:
        yield
    finally:
        _RAY_ROWS.reset(token)


def per_ray(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape), whose leading axis holds the rays (or a block of rows a
    ray, ray-major: a ray's samples).  Under ray_rows: draw at the whole
    batch's shape, then keep this rank's rows, so the values and the
    generator's state after the draw are those of the run over every ray."""
    rows = _RAY_ROWS.get()
    if rows is None:
        return draw(shape)
    index, n_global = rows
    per, rest = divmod(int(shape[0]), index.numel())
    if rest or per == 0:
        raise ValueError(f"a per-ray draw of {shape[0]} rows for {index.numel()} rays")
    full = draw((n_global * per, *shape[1:]))
    index = index.to(full.device)
    if per > 1:
        index = (index[:, None] * per + torch.arange(per, device=full.device)).reshape(-1)
    return full[index]


def cf_nerf_t_vals(
    n_samples: int = 128, dtype=torch.float32, device=None
) -> torch.Tensor:
    """CF-NeRF's schedule: 96 points in [0, 0.5) + 32 in [0.5, 1] at
    n_samples == 128; any other n_samples keeps the same 3:1 near/far split
    on uniform sub-schedules."""
    if n_samples == 128:
        t = np.concatenate([np.linspace(0.0, 0.5, 97)[:-1], np.linspace(0.5, 1.0, 32)])
    else:
        n_near = (3 * n_samples) // 4
        n_far = n_samples - n_near
        t = np.concatenate(
            [np.linspace(0.0, 0.5, n_near + 1)[:-1], np.linspace(0.5, 1.0, n_far)]
        )
    return torch.as_tensor(t, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _device_t_vals(n_samples: int, device: torch.device) -> torch.Tensor:
    """cf_nerf_t_vals on `device`, made once a sample count and device: the
    copy from the host is then never part of a step, nor of the step's CUDA
    graph (train/graph.py), which cannot capture one.  Read only; never an
    inference tensor."""
    with torch.inference_mode(False):
        return cf_nerf_t_vals(n_samples, device=device)


def sample_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    *,
    lindisp: bool = False,
    uniform: bool = False,
) -> torch.Tensor:
    """Map the t schedule into metric depths.  near/far: (R, 1) tensors.
    Returns z_vals (R, n_samples); lindisp samples linearly in inverse depth."""
    if uniform:
        t_vals = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    else:
        t_vals = _device_t_vals(n_samples, near.device)
    if not lindisp:
        return near * (1.0 - t_vals) + far * t_vals
    return 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)


def stratified_perturb(
    z_vals: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_rand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified jitter: one uniform draw inside each bin whose edges are
    midpoints between adjacent samples (first/last edges clamped to the
    endpoints).  `t_rand` injects the uniforms (tests feed both frameworks
    the same numbers); otherwise they come from `generator`, drawn on the
    generator's device and moved to z_vals' device, so one generator on
    either device drives every draw of a step."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t_rand is None:
        device = z_vals.device if generator is None else generator.device
        t_rand = per_ray(lambda shape: torch.rand(
            shape, generator=generator, dtype=z_vals.dtype, device=device), z_vals.shape
        ).to(z_vals)
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    *,
    det: bool,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples depths from a piecewise-constant
    pdf over `bins`.  bins: (R, M+1) increasing edges; weights: (R, M)
    unnormalized densities.  Returns (R, n_samples).

    The uniforms are linspace(0, 1) when `det` (or with neither `u` nor a
    generator), else `u` (R, n_samples) when given (tests inject JAX's
    draws), else drawn from `generator` on its device.  The JAX package's
    semantics, computed as a GPU does it: the cdf by cumsum where the TPU
    multiplies by a triangular ones matrix, and searchsorted where it takes
    masked max/min reductions.  The two pick the same bins: "below" is the
    last edge whose cdf <= u, "above" the first whose cdf > u, clipped to
    the top edge when u reaches it, and the interval is 1 where the cdf step
    is < 1e-5."""
    weights = weights + 1e-5  # prevent NaNs from empty rays
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # (R, M+1)
    shape = (*cdf.shape[:-1], n_samples)
    if det or (u is None and generator is None):
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = per_ray(lambda s: torch.rand(s, generator=generator, dtype=cdf.dtype,
                                         device=generator.device), shape).to(cdf)
    u = u.to(cdf).contiguous()

    m = cdf.shape[-1] - 1
    above = torch.searchsorted(cdf.contiguous(), u, right=True)  # first cdf > u
    below = above - 1  # cdf[0] = 0 <= u
    above = torch.clamp(above, max=m)
    cdf_below, cdf_above = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_below, bins_above = torch.gather(bins, -1, below), torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
