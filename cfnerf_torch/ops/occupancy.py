"""Proposal-placed sample placement; counterpart of cfnerf_tpu/ops/occupancy.py.

A cheap density proxy of the trained field places a small number of samples
along each ray by inverse CDF over proxy-composited visibility weights, so
each sample that pays a network query lands where the field says visible
surfaces are.  Two proxies:

  * a voxel grid baked once from the field (`bake_density_grid`: max-over-K
    or mean-draw density at every cell centre, 3x3x3 max-pool dilated), read
    by nearest-cell lookup (`grid_lookup`);
  * a small MLP distilled from the field (`ProposalMLP`, `distill_proposal`),
    or co-trained beside it inside the training step (train/step.py,
    OccTrainConfig).

Placement (`place_from_sigma`) composites the proxy over C uniform candidate
bins (alpha = 1 - exp(-sigma delta |d|), w = T alpha), mixes in a uniform
floor so that every ray stays renderable, and inverts the piecewise-linear
CDF in one clamp-and-sum pass over the (R, N, C) tensor.  The prefix sums are
torch.cumsum where JAX multiplies by triangular ones matrices at
Precision.HIGHEST: the same sums in another order.

Everything here is plain PyTorch, as JAX's module is plain JAX outside any
Pallas kernel.  The field's density queries (`density_query`) run the model
in test mode, on the card through its flow-stack forward kernel and its
trunk per trunk_impl; the placed depths go through the renderer's z_vals
seam into the render core, at any sample count.

--occ_impl auto takes the grid on every backend that is not a TPU
(cfnerf_tpu/ops/occupancy.py:487-488), so on the card auto means the grid;
the proposal is taken by asking for it.
"""
from __future__ import annotations

import time
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfnerf_torch.ops.compositing import softplus
from cfnerf_torch.ops.embed import positional_encoding
from cfnerf_torch.ops.rays import get_rays
from cfnerf_torch.ops.sampling import per_ray
from cfnerf_torch.render.renderer import prepare_rays, unfused_forward_members
from cfnerf_torch.utils.device import DeviceLike, resolve_device

SigmaFn = Callable[[torch.Tensor], torch.Tensor]
OCC_IMPLS = ("auto", "grid", "proposal")


def aabb_from_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    pad: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounds of everything the rays can sample: the hull of
    o + d near and o + d far, padded by `pad` of the extent on every side.
    Returns (lo, hi), each (3,), on the rays' device."""
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32).reshape(-1, 3)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32, device=rays_o.device).reshape(-1, 3)
    shape = rays_o[:, :1].shape

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32, device=rays_o.device).broadcast_to(shape)

    pts = torch.cat([rays_o + rays_d * col(near), rays_o + rays_d * col(far)], 0)
    lo = pts.min(0).values
    hi = pts.max(0).values
    margin = pad * (hi - lo)
    return lo - margin, hi + margin


def grid_coords(resolution: int, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(res^3, 3) world-space cell centres, x-major like the grid layout."""
    t = (torch.arange(resolution, dtype=torch.float32, device=lo.device) + 0.5) / resolution
    axes = [lo[i] + t * (hi[i] - lo[i]) for i in range(3)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


def bake_density_grid(
    density_fn: SigmaFn,
    lo: torch.Tensor,
    hi: torch.Tensor,
    *,
    resolution: int = 128,
    chunk: int = 65536,
    dilate: int = 1,
) -> torch.Tensor:
    """Query `density_fn((P, 3) pts) -> (P,) sigma >= 0` at every cell centre,
    `chunk` points at a time, and return the (res, res, res) f32 grid, max-pool
    dilated `dilate` times (3x3x3) so that thin structures straddling cell
    boundaries survive nearest-cell lookup."""
    pts = grid_coords(resolution, lo, hi)
    sigma = torch.cat([density_fn(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)])
    grid = sigma.float().reshape(resolution, resolution, resolution)
    for _ in range(dilate):
        grid = _maxpool3(grid)
    return grid


def _maxpool3(grid: torch.Tensor) -> torch.Tensor:
    """3x3x3 max pool, stride 1, padded with -inf: JAX's reduce_window."""
    return F.max_pool3d(grid[None, None], kernel_size=3, stride=1, padding=1)[0, 0]


def grid_lookup(
    grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, pts: torch.Tensor
) -> torch.Tensor:
    """Nearest-cell sigma at world points (..., 3); out-of-bounds points take
    the boundary cell.  The cell index is u * res truncated to an integer and
    clipped to [0, res - 1]; clamping before the truncation gives the same
    index for every finite point and keeps the conversion in range."""
    res = grid.shape[0]
    u = (pts - lo) / (hi - lo)
    idx = torch.clamp(u * res, 0, res - 1).to(torch.int64)
    flat = (idx[..., 0] * res + idx[..., 1]) * res + idx[..., 2]
    return grid.reshape(-1)[flat]


def place_from_sigma(
    sigma_fn: SigmaFn,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    n_samples: int,
    *,
    n_candidates: int = 192,
    floor=0.01,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Place n_samples depths a ray by inverse CDF over the visibility weights
    that `sigma_fn((R, C, 3) pts) -> (R, C)` gives at the midpoints of C
    uniform bins over [near, far] (cfnerf_tpu/ops/occupancy.py:119-189).
    `floor` (a float or a scalar tensor) is the mass of the uniform mixture.

    Deterministic (u = linspace(0, 1, N)) unless draws are given: `u` (R, N)
    uniforms in [0, 1), or drawn from `generator` on its device; then each
    sample takes one draw in its equal-mass stratum, (i + u_i) / N.  Returns
    the sorted (R, n_samples) depths.

    The transmittance and CDF prefix sums are cumsum where JAX multiplies by
    triangular ones matrices: f32 sums in another order, a few ulp of each
    prefix.  At floor 0 an empty bin's pdf, ~1e-6 / C, is below one ulp of a
    cdf near 1, so a u that meets the cdf at a run of empty bins (u = 1 behind
    a surface) may land at either end of that run, as the CDF is flat there;
    JAX's rounding and this one pick ends independently."""
    R = rays_o.shape[0]
    dev = rays_o.device
    C = n_candidates
    near = torch.as_tensor(near, dtype=torch.float32, device=dev).broadcast_to((R, 1))
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).broadcast_to((R, 1))
    t_edges = torch.linspace(0.0, 1.0, C + 1, dtype=torch.float32, device=dev)
    z_edges = near + t_edges[None, :] * (far - near)              # (R, C+1)
    z_mid = 0.5 * (z_edges[:, 1:] + z_edges[:, :-1])              # (R, C)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[..., None]
    sigma = sigma_fn(pts)                                         # (R, C)

    delta = (z_edges[:, 1:] - z_edges[:, :-1]) * torch.linalg.norm(
        rays_d.float(), dim=-1, keepdim=True)
    tau = torch.clamp(sigma, min=0.0) * delta                     # optical depth a bin
    opt_depth = torch.cumsum(tau, -1)
    opt_depth = torch.cat([torch.zeros_like(tau[:, :1]), opt_depth[:, :-1]], -1)  # exclusive
    alpha = 1.0 - torch.exp(-tau)
    w = torch.exp(-opt_depth) * alpha
    # the 1e-6 keeps the pdf positive at floor 0 (empty rays)
    w = w + (floor + 1e-6) / C

    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf_lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], -1)

    if u is None and generator is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                           device=dev).expand(R, n_samples)
    else:
        if u is None:
            u = per_ray(lambda shape: torch.rand(shape, generator=generator,
                                                 dtype=torch.float32,
                                                 device=generator.device), (R, n_samples))
        u = (torch.arange(n_samples, dtype=torch.float32, device=dev)
             + torch.as_tensor(u, dtype=torch.float32, device=dev)) / n_samples
    # the piecewise-linear inverse CDF over uniform bins, one fused pass
    seg = (u[:, :, None] - cdf_lo[:, None, :]) / pdf[:, None, :]  # (R, N, C)
    t_inv = torch.sum(torch.clamp(seg, 0.0, 1.0), -1) / C
    z = near + t_inv * (far - near)
    # the inverse CDF of sorted u is sorted; stratified draws need the sort
    return torch.sort(z, -1).values


def occ_z_vals(
    grid: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    n_samples: int,
    *,
    n_candidates: int = 192,
    floor=0.01,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grid-backed placement: place_from_sigma with the nearest-cell lookup
    as the density proxy."""
    return place_from_sigma(
        lambda pts: grid_lookup(grid, lo, hi, pts), rays_o, rays_d, near, far,
        n_samples, n_candidates=n_candidates, floor=floor, generator=generator, u=u)


def make_occ_render_rays(
    base_render_rays: Callable,
    grid: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    n_samples: int,
    *,
    n_candidates: int = 192,
    floor=0.01,
) -> Callable:
    """Grid-backed renderer wrapper: make_placed_render_rays with the
    nearest-cell lookup as the density proxy."""
    return make_placed_render_rays(
        base_render_rays, lambda pts: grid_lookup(grid, lo, hi, pts), n_samples,
        n_candidates=n_candidates, floor=floor)


class ProposalMLP(nn.Module):
    """The small density proxy sigma_hat(x) = softplus(MLP(gamma(2 x - 1)))
    over unit-cube points (cfnerf_tpu/ops/occupancy.py:244-295): positional
    encoding at `multires`, `depth` ReLU layers of `width` computed in bf16,
    the last layer and the softplus in f32.  The parameters are f32.

    JAX's w{i} is (d_in, d_out); here layers[i] is an nn.Linear, weight
    (d_out, d_in) (cfnerf_torch.convert.proposal_state_dict_from_jax).  The
    weights are drawn U(+-sqrt(6 / d_in)), the biases zero, from `generator`
    on its device (a CPU generator seeded 0 without one); the module lives
    on `device` (the CPU without one)."""

    def __init__(self, width: int = 64, depth: int = 2, multires: int = 4, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = "cpu"):
        super().__init__()
        self.width, self.depth, self.multires = width, depth, multires
        self.in_dim = 3 + 3 * 2 * multires
        dims = [self.in_dim] + [width] * depth + [1]
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out, device=device) for d_in, d_out in zip(dims[:-1], dims[1:]))
        g = torch.Generator().manual_seed(0) if generator is None else generator
        with torch.no_grad():
            for layer in self.layers:
                bound = float(np.sqrt(6.0 / layer.in_features))
                w = torch.empty(layer.weight.shape, device=g.device).uniform_(
                    -bound, bound, generator=g)
                layer.weight.copy_(w)
                layer.bias.zero_()

    def forward(self, pts_unit: torch.Tensor) -> torch.Tensor:
        """pts_unit (..., 3) in [0, 1] -> sigma_hat (...) >= 0 (JAX's apply).
        Each hidden layer is the bf16 product, then the bf16 bias added to
        it, as JAX rounds them: not addmm, which adds the bias before the
        product's rounding."""
        h = positional_encoding(2.0 * pts_unit - 1.0, self.multires).to(torch.bfloat16)
        for layer in self.layers[:-1]:
            h = torch.relu(h @ layer.weight.to(torch.bfloat16).T
                           + layer.bias.to(torch.bfloat16))
        last = self.layers[-1]
        h = h.float() @ last.weight.T + last.bias
        return softplus(h[..., 0])


def distill_proposal(
    density_fn: SigmaFn,
    lo: torch.Tensor,
    hi: torch.Tensor,
    generator: torch.Generator,
    *,
    width: int = 64,
    depth: int = 2,
    multires: int = 4,
    n_points: int = 1 << 20,
    batch: int = 1 << 14,
    epochs: int = 4,
    lr: float = 2e-3,
    chunk: int = 65536,
    pts_unit: Optional[torch.Tensor] = None,
    perms: Optional[Sequence[torch.Tensor]] = None,
    init: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[ProposalMLP, float]:
    """Distil the field into a ProposalMLP (cfnerf_tpu/ops/occupancy.py:
    298-362): regress log1p(sigma) at n_points uniform points of the aabb,
    `epochs` passes of Adam(lr) (optax's defaults: 0.9, 0.999, eps 1e-8) over
    whole batches of a fresh permutation.  Returns (proposal on lo's device,
    the last batch's loss).

    Every draw comes from `generator`, on its device: the pool, the initial
    weights, then each epoch's permutation.  The seams replace them: the
    pool `pts_unit` (n_points, 3), `perms` (one (n_points,) permutation an
    epoch) and `init` (the proposal's state_dict)."""
    dev = lo.device
    if pts_unit is None:
        pts_unit = torch.rand((n_points, 3), generator=generator, device=generator.device)
    pts_unit = torch.as_tensor(pts_unit, dtype=torch.float32).to(dev)
    with torch.no_grad():
        pts_world = lo + pts_unit * (hi - lo)
        sigma = torch.cat([density_fn(pts_world[i:i + chunk])
                           for i in range(0, n_points, chunk)])
        target = torch.log1p(sigma.float())

    prop = ProposalMLP(width, depth, multires, generator=generator, device=dev)
    if init is not None:
        prop.load_state_dict(init)
    opt = torch.optim.Adam(prop.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n_batches = n_points // batch
    loss = float("inf")
    for ep in range(epochs):
        if perms is None:
            perm = torch.randperm(n_points, generator=generator, device=generator.device)
        else:
            perm = torch.as_tensor(perms[ep])
        perm = perm.to(dev)[: n_batches * batch].reshape(n_batches, batch)
        for idx in perm:
            opt.zero_grad(set_to_none=True)
            pred = torch.log1p(prop(pts_unit[idx]))
            step_loss = torch.mean((pred - target[idx]) ** 2)
            step_loss.backward()
            opt.step()
        if n_batches:
            loss = float(step_loss.detach())
    return prop, loss


def make_proposal_sigma_fn(prop: ProposalMLP, lo: torch.Tensor, hi: torch.Tensor) -> SigmaFn:
    """sigma_fn for place_from_sigma: world points -> the proposal's density,
    with the module's current weights."""

    def sigma_fn(pts: torch.Tensor) -> torch.Tensor:
        return prop(torch.clamp((pts - lo) / (hi - lo), 0.0, 1.0))

    return sigma_fn


def make_placed_render_rays(
    base_render_rays: Callable,
    sigma_fn: SigmaFn,
    n_samples: int,
    *,
    n_candidates: int = 192,
    floor=0.01,
) -> Callable:
    """Wrap a renderer (make_render_rays' output) so that its depths come
    from `sigma_fn`'s visibility weights; same call as the base renderer, so
    it drops into render_image.  In train mode with a generator the
    placement draws its stratified u first, then the base renderer draws;
    the keyword `place_u` (R, n_samples) injects the placement's draws, and
    every other keyword goes to the base renderer.  Placement runs without
    gradient."""

    def render_rays(rays_o, rays_d, viewdirs, near, far, generator=None, *, is_test,
                    place_u=None, **kw):
        with torch.no_grad():
            z_vals = place_from_sigma(
                sigma_fn, rays_o, rays_d, near, far, n_samples,
                n_candidates=n_candidates, floor=floor,
                generator=None if is_test else generator,
                u=None if is_test else place_u)
        return base_render_rays(rays_o, rays_d, viewdirs, near, far, generator,
                                is_test=is_test, z_vals=z_vals, **kw)

    return render_rays


def density_query_members(models: Sequence, config, reduce: str = "mean") -> Callable:
    """fn((M, P, 3) pts) -> [M (P,) sigma >= 0], each member's density at its
    own points from its current weights, read at each call (the co-training
    target, whose weights change every step): the embedded points with the
    view direction (0, 0, 1), the models in test mode (their fixed draws,
    test_draws; the mean draw last), then the mean draw's density
    (reduce="mean") or the max over the K draws ("max"), through softplus,
    each member's on its own points.  The M members of one model and shape
    (one member: any model) run through
    render/renderer.py:unfused_forward_members (NeRFFlows: one flow-stack
    launch a chain for all on the card, the trunk as the training step runs
    it; baselines: each member's net on its own points).  Runs without
    gradient."""
    if reduce not in ("mean", "max"):
        raise ValueError(f"reduce must be 'mean' or 'max', got {reduce!r}")
    embedder, embedder_dirs = config.embedders()

    def density_fn(pts: torch.Tensor) -> list:
        with torch.no_grad():
            emb = embedder(pts)
            if config.use_viewdirs and embedder_dirs is not None:
                zero_dirs = torch.zeros_like(pts)
                zero_dirs[..., 2] = 1.0
                emb = torch.cat([emb, embedder_dirs(zero_dirs)], -1)
            P = pts.shape[1]
            draws = [m.test_draws(P) for m in models]
            raw = unfused_forward_members(models, emb, draws, is_test=True)[0]
            out = []
            for i in range(len(models)):
                r = raw[i * P:(i + 1) * P]
                sig = r[..., -1, 3] if reduce == "mean" else r[..., 3].max(-1).values
                out.append(softplus(sig))
            return out

    return density_fn


def density_query(model, config, reduce: str = "mean") -> SigmaFn:
    """fn((P, 3) pts) -> (P,) sigma >= 0 from `model`'s current weights:
    density_query_members at one member.  On the card its flow stacks run
    through the flow-stack forward kernel (NeRFFlows.forward)."""
    members = density_query_members([model], config, reduce)
    return lambda pts: members(pts[None])[0]


def make_density_fn(model, config, reduce: str = "mean") -> SigmaFn:
    """The bake's density query (cfnerf_tpu/ops/occupancy.py:516-531): the
    module carries its weights, so this is density_query.  reduce="mean"
    (default) bakes the mean draw's density, the field the test-mode
    composite follows; "max" the envelope over the K draws, which flow-draw
    noise inflates in free space."""
    return density_query(model, config, reduce)


def aabb_from_scene(scene: Mapping, args, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling bounds of a scene: aabb_from_rays over every 16th prepared
    ray of each train camera, in the space the renderer samples (NDC for an
    LLFF run without --no_ndc).  `scene` holds H, W, focal, i_train, poses
    (c2w, (n, 3+, 4)), near and far.  On the card unless device="cpu"."""
    dev = resolve_device(device)
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    ndc = getattr(args, "dataset_type", "llff") == "llff" and not getattr(args, "no_ndc", False)
    parts = [], [], [], []
    for view in scene["i_train"]:
        c2w = torch.as_tensor(np.asarray(scene["poses"][view]), dtype=torch.float32, device=dev)
        ro, rd = get_rays(H, W, focal, c2w)
        ro, rd, _, nv, fv = prepare_rays(
            ro, rd, H=H, W=W, focal=focal, ndc=ndc, use_viewdirs=args.use_viewdirs,
            near=scene["near"], far=scene["far"])
        for acc, t in zip(parts, (ro, rd, nv, fv)):
            acc.append(t[::16])  # every 16th ray bounds the frustum
    return aabb_from_rays(*(torch.cat(p) for p in parts))


def serving_candidates(args) -> int:
    """Serving-side candidate count: --occ_eval_candidates (default 32), or
    with 0 the train-side --occ_candidates."""
    return int(getattr(args, "occ_eval_candidates", 0) or 0) or int(args.occ_candidates)


def wrap_renderer_for_serving(render_rays_fn: Callable, args, scene: Mapping, model,
                              render_config) -> Callable:
    """Serving entry (cfnerf_tpu/ops/occupancy.py:460-513): build the density
    proxy from `model` and wrap `render_rays_fn` (built at the placed
    n_samples) so that its depths come from proxy-composited visibility
    weights.  The aabb comes from the scene's train cameras
    (aabb_from_scene), on the model's device.

    --occ_impl: 'grid' bakes a --occ_res^3 grid (--occ_dilate passes); 'auto'
    is 'grid' here, as JAX picks the grid on every backend but a TPU, so on
    the card too; 'proposal' distils a ProposalMLP (defaults of
    distill_proposal, its generator on the model's device seeded --seed).
    The returned renderer's `placement` dict says what was built (impl, the
    proxy: the grid or the proposal, aabb, n_candidates, floor) and how long
    it took (seconds; the grid's occupied share or the distillation's final
    loss)."""
    impl = args.occ_impl
    if impl not in OCC_IMPLS:
        raise ValueError(f"--occ_impl must be one of {OCC_IMPLS}, got {impl!r}")
    dev = next(model.parameters()).device
    lo, hi = aabb_from_scene(scene, args, dev)
    density_fn = make_density_fn(model, render_config)
    n_cand = serving_candidates(args)
    if impl == "auto":
        impl = "grid"
    t0 = time.perf_counter()
    if impl == "proposal":
        generator = torch.Generator(device=dev).manual_seed(int(getattr(args, "seed", 0) or 0))
        prop, loss = distill_proposal(density_fn, lo, hi, generator)
        placement = dict(impl=impl, seconds=time.perf_counter() - t0, final_loss=loss,
                         proxy=prop)
        print(f"proposal MLP distilled in {placement['seconds']:.1f}s "
              f"(final log1p-sigma MSE {loss:.4f})", flush=True)
        render_rays = make_placed_render_rays(
            render_rays_fn, make_proposal_sigma_fn(prop, lo, hi), render_config.n_samples,
            n_candidates=n_cand, floor=args.occ_floor)
    else:
        grid = bake_density_grid(density_fn, lo, hi, resolution=args.occ_res,
                                 dilate=args.occ_dilate)
        occupied = float((grid > 1e-2).float().mean())
        placement = dict(impl=impl, seconds=time.perf_counter() - t0, occupied=occupied,
                         proxy=grid)
        print(f"occupancy grid baked in {placement['seconds']:.1f}s: {args.occ_res}^3, "
              f"{100 * occupied:.1f}% occupied (sigma > 1e-2)", flush=True)
        render_rays = make_occ_render_rays(
            render_rays_fn, grid, lo, hi, render_config.n_samples,
            n_candidates=n_cand, floor=args.occ_floor)
    render_rays.placement = dict(placement, aabb=(lo, hi), n_candidates=n_cand,
                                 floor=args.occ_floor)
    return render_rays
