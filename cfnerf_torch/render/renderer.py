"""Volume renderer: ray batch -> K-sample rgb, disparity, depth, acc;
counterpart of cfnerf_tpu/render/renderer.py (reference render_rays,
run_nerf_uncertainty_NF.py:457-553, and render_path's single-pose render).

The fused path sends flows + composite through the render core
(cfnerf_torch/ops/kernels/render_core.py): the CUDA kernel on the card, its
plain version on the CPU, or with RenderConfig.fused == "interpret" its plain
version on either.  There is no shape gate: every ray batch without a fine
pass or applied noise takes it, unless RenderConfig.fused is "off".  The
unfused path (model forward, its flow stacks in the flow-stack kernels, then
raw2outputs) returns per-sample weights; it serves hierarchical sampling
(coarse + fine pass, nerf-pytorch semantics) and applied density noise, and
is the fused path's oracle.  The reference's never-applied raw noise is kept
(apply_noise=False).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cfnerf_torch.models.baseline_adapter import KSampleBaseline, baseline_forward_members
from cfnerf_torch.models.nerf_flows import forward_composited_members, forward_members
from cfnerf_torch.ops.compositing import LAST_DIST, finalize_k_maps, raw2outputs
from cfnerf_torch.ops.embed import Embedder
from cfnerf_torch.ops.rays import get_rays, ndc_rays
from cfnerf_torch.ops.sampling import sample_pdf, sample_z_vals, stratified_perturb
from cfnerf_torch.utils.device import DeviceLike, resolve_device
from cfnerf_torch.utils.trace import span


FUSED_MODES = ("on", "off", "interpret")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration.  `fused` is the render-core choice of
    cfnerf_tpu's RenderConfig ('on' | 'off' | 'interpret'; the factory
    resolves --fused_render auto to 'on'): 'on' takes the render core, whose
    tensors' device decides between kernel and plain version; 'off' the
    unfused path; 'interpret' the render core's plain version on any
    device."""

    n_samples: int = 128
    n_importance: int = 0
    perturb: bool = True
    lindisp: bool = False
    use_viewdirs: bool = True
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    apply_noise: bool = False  # reference parity: noise is never applied
    uniform: bool = False
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0
    fused: str = "on"

    def embedders(self) -> Tuple[Embedder, Optional[Embedder]]:
        if self.i_embed == -1:
            emb = Embedder(num_freqs=0)
            emb_dirs = Embedder(num_freqs=0) if self.use_viewdirs else None
        else:
            emb = Embedder(num_freqs=self.multires, max_freq_log2=self.multires - 1)
            emb_dirs = (
                Embedder(num_freqs=self.multires_views,
                         max_freq_log2=self.multires_views - 1)
                if self.use_viewdirs else None
            )
        return emb, emb_dirs


RenderRays = Callable[..., Dict[str, torch.Tensor]]


def embed_samples(config: RenderConfig, embedders, z_vals: torch.Tensor,
                  rays_o: torch.Tensor, rays_d: torch.Tensor,
                  viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """The positional encoding of every sample of every ray, (R * S, C),
    sample minor: the points, then the ray's view directions beside each
    sample's.  `embedders` is config.embedders()."""
    embedder, embedder_dirs = embedders
    R, S = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    emb = embedder(pts.reshape(R * S, 3))
    if config.use_viewdirs and viewdirs is not None:
        emb_dirs = embedder_dirs(viewdirs)  # (R, Dv)
        emb_dirs = emb_dirs[:, None, :].expand(R, S, emb_dirs.shape[-1])
        emb = torch.cat([emb, emb_dirs.reshape(R * S, -1)], -1)
    return emb


def schedule_z_vals(config: RenderConfig, near: torch.Tensor, far: torch.Tensor,
                    generator: Optional[torch.Generator], is_test: bool) -> torch.Tensor:
    """The rays' sample depths (R, config.n_samples): the z schedule
    between near and far (R, 1), jittered by stratified_perturb from
    `generator` in a perturbed train-mode render."""
    R, S = near.shape[0], config.n_samples
    z_vals = sample_z_vals(near, far, S, lindisp=config.lindisp,
                           uniform=config.uniform).expand(R, S)
    if config.perturb and not is_test and generator is not None:
        z_vals = stratified_perturb(z_vals, generator)
    return z_vals


def point_intervals(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """The render core's d_pts: each sample's interval to the next (the
    last LAST_DIST) times |rays_d|, (R, S)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], LAST_DIST)], -1)
    return dists * torch.linalg.norm(rays_d.float(), dim=-1, keepdim=True)


def unfused(config: RenderConfig) -> bool:
    """Whether a render takes the unfused path: RenderConfig.fused 'off',
    hierarchical sampling, or applied density noise (as JAX routes it,
    cfnerf_tpu/render/renderer.py:188-199)."""
    noisy = config.apply_noise and config.raw_noise_std > 0
    return config.fused == "off" or config.n_importance > 0 or noisy


def _checkpointed(remat: bool, forward: Callable) -> Callable:
    """`forward`, or with `remat` `forward` under a non-reentrant activation
    checkpoint (torch.utils.checkpoint, JAX's jax.checkpoint)."""
    if not remat:
        return forward
    return lambda *args, **kwargs: checkpoint(forward, *args, use_reentrant=False, **kwargs)


def unfused_forward_members(models: Sequence, x: torch.Tensor, draws: Sequence, *,
                            is_test: bool) -> Tuple[torch.Tensor, list]:
    """The unfused forward of M members of one model (x (M, B, C), draws
    each member's train_eps / test_draws): NeRFFlows' forward_members or
    the baselines' baseline_forward_members.  Returns raw (M * B, K, 4),
    the points member-major, and the M entropies."""
    if isinstance(models[0], KSampleBaseline):
        return baseline_forward_members(models, x, draws, is_test=is_test)
    return forward_members(models, x, draws, is_test=is_test)


def render_members(
    models: Sequence,
    config: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    z_vals: torch.Tensor,
    draws: Sequence,
    *,
    is_test: bool,
    generators: Optional[Sequence[Optional[torch.Generator]]] = None,
    noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
    rows: Optional[Callable[[int], ContextManager]] = None,
    remat: bool = False,
) -> List[Dict[str, torch.Tensor]]:
    """The render of M members of one model and shape (an ensemble's
    members, or one net: NeRFFlows of one family, or baselines of one kind)
    at given depths, JAX's vmapped render_rays: rays_o, rays_d, viewdirs
    (M * R, 3) and z_vals (M * R, S), the rays member-major; `draws` each
    member's draws (train_eps / test_draws).  The positional encoding and
    the sample intervals run once over all members' rays.  The fused path
    (not `unfused(config)`; no fine pass; the triangular family) takes
    forward_composited_members, the render core and the trunk kernels one
    launch for all members; the unfused one unfused_forward_members
    (NeRFFlows: the triangular flow-stack kernel one launch a chain for
    all, the other families' eager flows once on the joined points; the
    baselines' nets member by member), then raw2outputs member by member on each member's rays, as its own
    render composites them (on the CPU a call over more rays may round
    log1p and sigmoid elsewhere), its density noise (apply_noise)
    `noise[m]` or drawn from `generators[m]` in train mode, inside `rows(m)`
    where given (a data-parallel rank's rows).  With
    `remat` (train mode) the members' forward, fused or unfused, runs under
    one activation checkpoint: recomputed in the backward on the same
    draws.  Returns a dict a member: rgb_map, disp_map, depth_map, acc_map,
    loss_entropy, and unfused in train mode the weights."""
    M = len(models)
    n_rays, S = z_vals.shape[0] // M, z_vals.shape[1]
    emb = embed_samples(config, config.embedders(), z_vals, rays_o, rays_d, viewdirs)
    emb = emb.view(M, n_rays * S, -1)
    out = []
    remat = remat and not is_test
    if isinstance(models[0], KSampleBaseline) and not unfused(config):
        raise ValueError("a baseline has no fused render: RenderConfig.fused must be 'off'")
    if not unfused(config):
        rgb, depth, acc, entropy = _checkpointed(remat, forward_composited_members)(
            models, emb, z_vals.view(M, -1), point_intervals(z_vals, rays_d).view(M, -1), S,
            draws, is_test=is_test, interpret=config.fused == "interpret")
        rgb, disp = finalize_k_maps(rgb, depth, acc, config.white_bkgd)
        for m in range(M):
            ray = slice(m * n_rays, (m + 1) * n_rays)
            out.append(dict(rgb_map=rgb[ray], disp_map=disp[ray], depth_map=depth[ray],
                            acc_map=acc[ray], loss_entropy=entropy[m]))
        return out
    raw, entropy = _checkpointed(remat, unfused_forward_members)(models, emb, draws,
                                                                 is_test=is_test)
    for m in range(M):
        ray = slice(m * n_rays, (m + 1) * n_rays)
        with rows(m) if rows is not None else contextlib.nullcontext():
            rgb, disp, acc, weights, depth = raw2outputs(
                raw[m * n_rays * S:(m + 1) * n_rays * S].reshape(n_rays, S, -1, 4),
                z_vals[ray], rays_d[ray], raw_noise_std=config.raw_noise_std,
                white_bkgd=config.white_bkgd, apply_noise=config.apply_noise,
                generator=None if is_test or generators is None else generators[m],
                noise=None if noise is None else noise[m])
        maps = dict(rgb_map=rgb, disp_map=disp, depth_map=depth, acc_map=acc,
                    loss_entropy=entropy[m])
        if not is_test:
            maps["weights"] = weights
        out.append(maps)
    return out


def render_members_test(models: Sequence, config: RenderConfig, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, viewdirs: Optional[torch.Tensor],
                        near: torch.Tensor, far: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """One test-mode render of the same R rays by each of M members of one
    model and shape at once (NeRFFlows of one family, or baselines of one
    kind), JAX's vmapped val_fn: the rays repeated member-major, the
    schedule's depths, each member's fixed test draws (test_draws),
    render_members.
    Returns a dict a member, each bitwise its own make_render_rays
    render's."""
    M = len(models)
    rays_o, rays_d, near, far = (t.repeat(M, 1) for t in (rays_o, rays_d, near, far))
    viewdirs = None if viewdirs is None else viewdirs.repeat(M, 1)
    z_vals = schedule_z_vals(config, near, far, None, is_test=True).contiguous()
    n_points = z_vals.numel() // M
    draws = [m.test_draws(n_points) for m in models]
    return render_members(models, config, rays_o, rays_d, viewdirs, z_vals, draws,
                          is_test=True)


def make_render_rays(model, config: RenderConfig, model_fine=None) -> RenderRays:
    """Build the per-batch renderer around a NeRFFlows `model`.

    render_rays(rays_o (R,3), rays_d (R,3), viewdirs (R,3) or None,
    near (R,1), far (R,1), generator=None, *, is_test, z_vals=None, eps=None,
    eps_fine=None, pdf_u=None, noise=None):
    z schedule -> stratified jitter (training, with a generator) ->
    positional encoding -> model -> composite.  `z_vals` (R, S) replaces the
    schedule and its jitter, as in the JAX renderer; `eps` (eps_a (K,1),
    eps_r (K,3)) replaces the model's base draws.  config.fused picks the
    render core ('on', the serving and training path, or 'interpret') or
    the unfused oracle ('off').

    With config.n_importance > 0 the render is hierarchical
    (cfnerf_tpu/render/renderer.py:221-278): the coarse pass, then
    n_importance depths resampled by `sample_pdf` from its gradient-stopped
    mean-over-K weights, then the fine pass on the sorted union through
    `model_fine`, or through `model` itself without one (the eval-only
    importance placement, --N_importance_eval).  The coarse maps come back
    as rgb0/disp0/depth0/loss_entropy0.  Hierarchical sampling and applied
    noise take the unfused path, as in the JAX package.

    The other seams feed the port JAX's draws in the tests: `eps_fine`
    replaces the fine pass's base draws, `pdf_u` (R, n_importance) the
    uniforms of a perturbed train-mode resample, `noise` the density noise,
    one (R, S_pass, K) tensor per pass in order.  Without them every draw
    comes from `generator`, one after another."""
    if config.fused not in FUSED_MODES:
        raise ValueError(f"RenderConfig.fused must be one of {FUSED_MODES}, "
                         f"got {config.fused!r}")
    embedders = config.embedders()
    unfused_path = unfused(config)

    def _embed(z_vals, rays_o, rays_d, viewdirs):
        return embed_samples(config, embedders, z_vals, rays_o, rays_d, viewdirs)

    def _pass(net, z_vals, rays_o, rays_d, viewdirs, generator, is_test, eps, noise):
        """One unfused query + composite: (maps..., weights, entropy)."""
        R, S = z_vals.shape
        raw, loss_entropy = net(_embed(z_vals, rays_o, rays_d, viewdirs),
                                is_test=is_test, generator=generator, eps=eps)
        rgb_map, disp_map, acc_map, weights, depth_map = raw2outputs(
            raw.reshape(R, S, -1, 4), z_vals, rays_d,
            raw_noise_std=config.raw_noise_std,
            white_bkgd=config.white_bkgd,
            apply_noise=config.apply_noise,
            generator=generator, noise=noise,
        )
        return rgb_map, disp_map, acc_map, depth_map, weights, loss_entropy

    def render_rays(
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        viewdirs: Optional[torch.Tensor],
        near: torch.Tensor,
        far: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        *,
        is_test: bool,
        z_vals: Optional[torch.Tensor] = None,
        eps=None,
        eps_fine=None,
        pdf_u: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        if z_vals is None:
            z_vals = schedule_z_vals(config, near, far, generator, is_test)
        S = z_vals.shape[1]

        if not unfused_path:
            d_pts = point_intervals(z_vals, rays_d)
            rgb_map, depth_map, acc_map, loss_entropy = model.forward_composited(
                _embed(z_vals, rays_o, rays_d, viewdirs), z_vals.reshape(-1),
                d_pts.reshape(-1), S, is_test=is_test, generator=generator, eps=eps,
                interpret=config.fused == "interpret",
            )
            rgb_map, disp_map = finalize_k_maps(
                rgb_map, depth_map, acc_map, config.white_bkgd
            )
            return dict(rgb_map=rgb_map, disp_map=disp_map, depth_map=depth_map,
                        acc_map=acc_map, loss_entropy=loss_entropy)

        noise = (None, None) if noise is None else tuple(noise) + (None,)
        rgb_map, disp_map, acc_map, depth_map, weights, loss_entropy = _pass(
            model, z_vals, rays_o, rays_d, viewdirs, generator, is_test, eps, noise[0])
        out: Dict[str, torch.Tensor] = {}
        if config.n_importance > 0:
            out.update(rgb0=rgb_map, disp0=disp_map, depth0=depth_map,
                       loss_entropy0=loss_entropy)
            # importance-resample from the coarse density (mean over K)
            w_mean = weights.detach().mean(-1)  # (R, S)
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(
                z_mid, w_mean[..., 1:-1], config.n_importance, generator,
                det=(not config.perturb) or is_test, u=pdf_u,
            ).detach()
            z_vals = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
            net = model if model_fine is None else model_fine
            rgb_map, disp_map, acc_map, depth_map, weights, loss_entropy = _pass(
                net, z_vals, rays_o, rays_d, viewdirs, generator, is_test,
                eps_fine, noise[1])

        out.update(rgb_map=rgb_map, disp_map=disp_map, depth_map=depth_map,
                   acc_map=acc_map, loss_entropy=loss_entropy)
        if not is_test:
            out["weights"] = weights
        return out

    return render_rays


def prepare_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    H: int,
    W: int,
    focal: float,
    ndc: bool,
    use_viewdirs: bool,
    near: float,
    far: float,
):
    """Flatten / NDC / viewdirs plumbing (reference render(), :129-158).
    Returns (rays_o, rays_d, viewdirs or None, near (R,1), far (R,1))."""
    if use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    else:
        viewdirs = None
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    near_v = near * torch.ones_like(rays_d[..., :1])
    far_v = far * torch.ones_like(rays_d[..., :1])
    return rays_o, rays_d, viewdirs, near_v, far_v


def render_image(
    render_rays_fn: RenderRays,
    c2w,
    *,
    H: int,
    W: int,
    focal: float,
    ndc: bool,
    use_viewdirs: bool,
    near: float,
    far: float,
    tile: int = 4096,
    device: DeviceLike = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Full-image test-mode render, in tiles of `tile` rays.

    Pads the ray count up to a tile multiple by repeating the last ray,
    renders each tile in turn and strips the padding after.  Runs under
    torch.inference_mode() on the CUDA device unless device="cpu".
    Returns per-pixel maps: rgb_map (H, W, 3, K), disp/depth/acc (H, W, K).

    With `mesh` (parallel/mesh.py; every rank calls it) the tile is rounded
    up to a multiple of the data axis and each tile's rays are split over
    the data ranks: each renders its part and the parts are all-gathered,
    so every rank returns the whole image (JAX's mesh render,
    cfnerf_tpu/render/renderer.py:327-395).  A tensor-parallel net's model
    ranks render the same part together.

    Spans (utils/trace.py, while a profile records): cfnerf.render.rays
    (rays, prepared and padded), cfnerf.render.tile (one a tile) and
    cfnerf.render.gather (the maps put together)."""
    dev = resolve_device(device)
    part, lo = tile, 0
    if mesh is not None:
        from cfnerf_torch.parallel.mesh import DATA_AXIS, all_gather

        n_data = mesh.shape[DATA_AXIS]
        tile = -(-tile // n_data) * n_data  # round up: the tile splits evenly
        part = tile // n_data
        lo = mesh.index(DATA_AXIS) * part
    with torch.inference_mode():
        with span("cfnerf.render.rays"):
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
            rays_o, rays_d = get_rays(H, W, focal, c2w)
            rays_o, rays_d, viewdirs, near_v, far_v = prepare_rays(
                rays_o, rays_d, H=H, W=W, focal=focal, ndc=ndc,
                use_viewdirs=use_viewdirs, near=near, far=far,
            )
            n = rays_o.shape[0]
            n_pad = (-n) % tile

            def pad(x):
                return torch.cat([x, x[-1:].expand(n_pad, *x.shape[1:])], 0)

            rays_o, rays_d, near_v, far_v = map(pad, (rays_o, rays_d, near_v, far_v))
            if viewdirs is not None:
                viewdirs = pad(viewdirs)

        pieces: Dict[str, list] = {}
        for start in range(0, n + n_pad, tile):
            with span("cfnerf.render.tile"):
                sl = slice(start + lo, start + lo + part)
                out = render_rays_fn(
                    rays_o[sl], rays_d[sl],
                    viewdirs[sl] if viewdirs is not None else None,
                    near_v[sl], far_v[sl], None, is_test=True,
                )
                for key, v in out.items():
                    # per-ray outputs only; scalars (loss_entropy) are dropped
                    if v.ndim >= 1 and v.shape[0] == part:
                        if mesh is not None:
                            v = all_gather(v, mesh.group(DATA_AXIS))
                        pieces.setdefault(key, []).append(v)
        with span("cfnerf.render.gather"):
            result = {}
            for key, vs in pieces.items():
                v = torch.cat(vs, 0)[:n]
                result[key] = v.reshape(H, W, *v.shape[1:])
        return result
