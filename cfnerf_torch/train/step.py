"""The training step; counterpart of cfnerf_tpu/train/step.py (one iteration
of the reference loop: render (run_nerf_uncertainty_NF.py:1014), loss block
(:1026-1054), Adam step (:1065-1067), continuous exponential lr decay
lr = lrate * 0.1^(step / (lrate_decay*1000)) (:1072-1077)).

  * the COLMAP depth rays are concatenated to the rgb rays before the render
    and split after, as in the reference (:1011, :1020-1024);
  * the render is the fused train-mode path (the render core's forward
    kernel on the card, its backward kernel through autograd), the unfused
    one (--fused_render off, applied density noise: the flow-stack kernels;
    the baselines' only render) or, with N_importance > 0, the hierarchical
    coarse + fine render, whose flow stacks run through the flow-stack
    kernels; its coarse loss is added as in cfnerf_tpu/train/step.py:290-
    304.  For NeRFFlows of any family and for the baselines, without a fine
    pass, fused or unfused, placed or not, with or without remat, the step
    is the member-batched loss, make_batched_loss, at one member, which the
    ensemble step runs at M;
  * a trunk_impl="pallas" net's trunk runs through the trunk kernels, its
    backward kernel through autograd, as the JAX step differentiates
    pallas_encode's custom VJP;
  * Adam (0.9, 0.999, eps 1e-8) with the JAX step's schedule, offset by
    `start_step` (cfnerf_tpu/train/step.py:92-105);
  * `remat` recomputes the train-mode model forward in the backward
    (torch.utils.checkpoint, the counterpart of jax.checkpoint): the
    batched loss's checkpoint, or _Remat's for a hierarchical render;
  * with `occ` (OccTrainConfig) the step trains on proposal-placed depths and
    co-trains the proposal after the field's update
    (cfnerf_tpu/train/step.py:36-60, :193-248, :318-354);
  * with `mesh` (parallel/mesh.py) the batch is this rank's shard of the
    ray axis (the caller shards it, as in JAX): the step draws what the
    one-device step draws over the whole batch and keeps its rows
    (ops/sampling.py:per_ray), all-reduces the mean gradient over the data
    axis once a step and returns the global mean metrics;
  * on a CUDA device, where graph_refusal says so, the step is one CUDA
    graph (train/graph.py): forward, backward and Adam replay at once, the
    draws made inside it from the generator the graph registers;
  * while a profile records (utils/trace.py) the step's phases are spans:
    cfnerf.train.zero_grad, .forward (the loss), .backward, .update (a
    mesh's all-reduce, Adam, the schedule) and, with `occ`, .cotrain; a
    graphed step's are cfnerf.train.stage (the inputs copied), .replay and
    .update (the schedule), and the counter
    train.graph_eager counts its calls that ran eagerly.

PyTorch runs eagerly: there is no jit, and `make_train_loop` is a Python
loop where the JAX package scans on the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import checkpoint

from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.metrics import img2mse, mse2psnr
from cfnerf_torch.ops.occupancy import (
    ProposalMLP,
    density_query_members,
    make_proposal_sigma_fn,
    place_from_sigma,
)
from cfnerf_torch.ops.sampling import ray_rows
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_members,
    schedule_z_vals,
)
from cfnerf_torch.train.graph import StepGraph
from cfnerf_torch.train.loss import kde_nll, total_loss
from cfnerf_torch.utils.trace import count, span

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OccTrainConfig:
    """Proposal-placed training, the occ stage (cfnerf_tpu/train/step.py:36).
    Each step places render_config.n_samples depths a ray by inverse CDF over
    the proposal's visibility weights at n_candidates bins (stratified u,
    the uniform floor mixed in), and after the field's Adam step fits the
    proposal once to log1p of the updated field's density at cotrain_points
    uniform points of the aabb (lo, hi), with an Adam of its own at prop_lr.
    The proposal and its optimizer live beside the step, not in the model's
    state_dict."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    n_candidates: int = 128
    floor: float = 0.3
    prop_width: int = 64
    prop_depth: int = 2
    prop_multires: int = 4
    prop_lr: float = 2e-3
    cotrain_points: int = 8192


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyperparameters, the fields of the JAX TrainConfig."""

    H: int
    W: int
    focal: float
    ndc: bool
    near: float
    far: float
    k_samples: int
    lrate: float = 5e-4
    lrate_decay: int = 250  # in 1000s of steps
    # global step the run (re)starts from: offsets the lr schedule
    start_step: int = 0
    beta1: float = 0.0
    colmap_depth: bool = False
    depth_lambda: float = 0.1
    # 'kde' (CF-NeRF sample NLL) or 'mse' (MSE on the mean-over-K render)
    loss_mode: str = "kde"
    # recompute the train-mode model forward in the backward
    remat: bool = False


def make_optimizer(params: Iterable, cfg: TrainConfig) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam (0.9, 0.999, eps 1e-8) and its schedule: update t (from 0) runs at
    lrate * 0.1^((start_step + t) / (lrate_decay * 1000)), as optax's
    exponential_decay counts.  Step the scheduler after each optimizer step.
    On a CUDA device Adam is fused and capturable, its step counts and lr on
    the device (an f32 tensor the schedule fills in place), so that the
    step's CUDA graph replays the update; eager steps run the same Adam.
    Fused, because the capturable multi-tensor Adam takes its bias
    corrections in f32 on the device (1 - 0.999 is 5e-5 off at the first
    update), where the fused one stays as close to an f64 Adam as the
    default on the host."""
    params = list(params)
    decay_steps = cfg.lrate_decay * 1000
    on_cuda = bool(params) and params[0].is_cuda
    lr = (torch.tensor(cfg.lrate, dtype=torch.float32, device=params[0].device)
          if on_cuda else cfg.lrate)
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 capturable=on_cuda, fused=on_cuda or None)
    if on_cuda:
        for group in optimizer.param_groups:
            # the schedule's base a float: a tensor's would be read back from
            # the device at every step of the schedule
            group["initial_lr"] = cfg.lrate
    scheduler = LambdaLR(
        optimizer, lambda t: 0.1 ** ((cfg.start_step + t) / decay_steps))
    return optimizer, scheduler


def score_render(out: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor], n_rgb: int,
                 cfg: TrainConfig, dev) -> Tuple[torch.Tensor, Metrics]:
    """A step's loss and metrics from its render `out` (rgb_map, depth_map,
    loss_entropy[, loss_entropy0, rgb0]) of the batch `b` (tensors), the
    first n_rgb rays the rgb rays, the rest COLMAP depth rays."""
    rgbs, depth = out["rgb_map"], out["depth_map"]  # (R+D, 3, K), (R+D, K)
    depth_k = target_depth = None
    if cfg.colmap_depth:
        rgbs, depth_k = rgbs[:n_rgb], depth[n_rgb:]
        target_depth = b["target_depth"]
    entropy = out["loss_entropy"]
    if "loss_entropy0" in out:
        entropy = entropy + out["loss_entropy0"]

    if cfg.loss_mode == "mse":
        loss = img2mse(rgbs.mean(-1), b["target"])
        metrics = {"loss_nll": torch.zeros((), device=dev), "loss_entropy": entropy}
        if depth_k is not None:
            d = img2mse(depth_k.mean(-1), target_depth)
            loss = loss + cfg.depth_lambda * d
            metrics["depth_loss"] = d
        metrics["loss"] = loss
    else:
        loss, metrics = total_loss(
            rgbs, b["target"], entropy, k_samples=cfg.k_samples, beta1=cfg.beta1,
            depth_k=depth_k, target_depth=target_depth,
            depth_lambda=cfg.depth_lambda)
    if "rgb0" in out:
        # the coarse loss, in the family of the fine one
        rgbs0 = out["rgb0"][:n_rgb]
        if cfg.loss_mode == "mse":
            loss0 = img2mse(rgbs0.mean(-1), b["target"])
        else:
            loss0 = kde_nll(rgbs0, b["target"], cfg.k_samples)
        loss = loss + loss0
        metrics["loss_nll0"] = loss0
        metrics["loss"] = loss
    mse = img2mse(rgbs.mean(-1), b["target"])
    metrics["mse"] = mse
    metrics["psnr"] = mse2psnr(mse)
    return loss, metrics


def mesh_rows(mesh, n_rgb: int, n_depth: int, device) -> Tuple[torch.Tensor, int]:
    """This data rank's rows among the whole batch's, for ray_rows: its
    n_rgb rgb rays, then its n_depth depth rays after every rank's rgb
    rays; and the whole batch's ray count."""
    from cfnerf_torch.parallel.mesh import DATA_AXIS

    n_data, data_index = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    rows = torch.cat([torch.arange(n_rgb, device=device) + data_index * n_rgb,
                      torch.arange(n_depth, device=device) + n_data * n_rgb
                      + data_index * n_depth])
    return rows, n_data * (n_rgb + n_depth)


def batch_rays(batch: Mapping, cfg: TrainConfig, render_config: RenderConfig, dev):
    """The batch's leaves as f32 tensors on dev, and its rays prepared for
    the render (prepare_rays): the rgb rays, then the COLMAP depth rays,
    flattened over any leading member axis, member-major."""
    b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}
    rays_o, rays_d = b["rays_o"], b["rays_d"]
    if cfg.colmap_depth:
        rays_o = torch.cat([rays_o, b["depth_rays_o"]], -2)
        rays_d = torch.cat([rays_d, b["depth_rays_d"]], -2)
    return b, prepare_rays(rays_o, rays_d, H=cfg.H, W=cfg.W, focal=cfg.focal, ndc=cfg.ndc,
                           use_viewdirs=render_config.use_viewdirs, near=cfg.near, far=cfg.far)


def _shape_key(m: torch.nn.Module) -> tuple:
    """What members batched together must share: a baseline's kind and
    base net, or a NeRFFlows' family, implementations and widths (a
    member's test-mode seed is its own)."""
    if isinstance(m, KSampleBaseline):
        b = m.base
        return ("baseline", m.kind, m.k_samples, b.depth, b.width, b.input_ch,
                b.input_ch_views, b.trunk.skips, b.use_viewdirs,
                getattr(b, "dropout_rate", None), b.compute_dtype)
    return ("flows", m.type_flows, m.trunk_impl, m.flow_impl, m.compute_dtype, m.k_samples,
            m.net_depth, m.net_width, m.input_ch, m.input_ch_views, m.skips,
            m.use_viewdirs, m.n_flows, m.h_alpha_linear.out_features,
            m.h_rgb_linear.out_features)


def batched_step_refusal(models: Sequence[torch.nn.Module], render_config: RenderConfig,
                         cfg: TrainConfig, model_fine=None, occ=None) -> Optional[str]:
    """None where make_batched_loss takes these nets (one, or an ensemble's
    members): NeRFFlows of one configuration, any flow family, the fused
    (triangular) or the unfused render (applied noise included), or
    baselines of one kind and configuration (unfused), placed (`occ`) or
    not, with or without remat; else what leaves them to the render of
    make_render_rays (an ensemble: to its members' steps in turn):
    hierarchical sampling (JAX's --parallel refuses it too), or members
    that differ."""
    if render_config.n_importance > 0 or any(f is not None for f in model_fine or ()):
        return "hierarchical sampling"
    if len({_shape_key(m) for m in models}) > 1:
        return "members of different configurations"
    return None


def graph_refusal(model, model_fine, render_config: RenderConfig, cfg: TrainConfig,
                  mesh=None, occ=None) -> Optional[str]:
    """None where make_train_step runs as one CUDA graph (train/graph.py):
    NeRFFlows of any family (and its fine net), fused or unfused, flat or
    hierarchical, either trunk_impl or compute dtype, on a CUDA device;
    else what keeps the step eager."""
    if mesh is not None:
        return "a mesh: the step all-reduces over the data axis"
    if occ is not None:
        return "occ: the step places its samples and co-trains the proposal with its own Adam"
    if cfg.remat:
        return "remat: the step recomputes its forward under activation checkpoints"
    if not all(isinstance(net, NeRFFlows) for net in (model, model_fine) if net is not None):
        return "a baseline: nerf_dropout checkpoints each draw, the baselines stay eager"
    if next(model.parameters()).device.type != "cuda":
        return "not on a CUDA device"
    return None


def _floor_of(b: Mapping, m: int, occ: "OccTrainConfig"):
    """Member m's placement floor: its entry of batch["occ_floor"] (M,) when
    the batch has one (the annealed floor), else occ.floor."""
    return b["occ_floor"][m] if "occ_floor" in b else occ.floor


def make_batched_loss(models: Sequence[torch.nn.Module], render_config: RenderConfig,
                      cfg: TrainConfig, mesh=None, occ=None,
                      proposals: Optional[Sequence[ProposalMLP]] = None) -> Callable:
    """The train-mode render and loss of M nets at once (members of an
    ensemble; batched_step_refusal says which configurations), JAX's
    vmapped loss written out: loss(batch, generators, *, z_vals, eps,
    place_u, noise) -> [(loss, metrics)], a pair a member.  The batch's
    leaves have the member axis first ((M, R, 3) rays, an (M,) occ_floor,
    ...); generators and the seams are lists of each member's (a seam None
    is drawn; eps a member's train_eps seam: NeRFFlows' base draws, nerf_
    dropout's K mask lists, nerf_wild's (K, 3) eps; noise a member's (R, S,
    K) density noise).  Member m's draws come from generators[m] in its
    single step's order: with `occ` (its proposal proposals[m]) the
    placement's stratified u, else the jitter; then the base draws (a
    baseline's masks or eps), then (unfused, applied noise) the density
    noise.
    Placement runs member by member on each member's rays and proposal, as
    its own step places them; the rays' preparation runs once over all
    members' rays, member-major, and the render is render_members (the
    render core, or the flow stack a chain, and the trunk kernels, one
    launch for all members; the other families' eager flows once on the
    joined points; the baselines' nets member by member); each member's
    loss is scored on its own rays, in cfg.loss_mode.  With
    cfg.remat the members' train-mode forward (trunks, amortizers, flows and
    the render core, or the unfused raw tensor) runs under one activation
    checkpoint and is recomputed in the backward, its draws made before it,
    as _Remat makes a single net's.  make_train_step runs it at one member,
    the ensemble step (parallel/ensemble.py) at M.  Under a mesh each per-ray draw is made at
    the whole batch's shape and cut to this rank's rows, and the seams
    z_vals, place_u and noise hold the whole batch's, as in
    make_train_step."""
    rc = render_config
    dev = next(models[0].parameters()).device
    if occ is not None:
        lo = torch.tensor(occ.lo, dtype=torch.float32, device=dev)
        hi = torch.tensor(occ.hi, dtype=torch.float32, device=dev)
        sigma_fns = [make_proposal_sigma_fn(p, lo, hi) for p in proposals]

    def loss(batch: Mapping, generators: Sequence[Optional[torch.Generator]], *,
             z_vals: Sequence, eps: Sequence, place_u: Optional[Sequence] = None,
             noise: Optional[Sequence] = None) -> List[Tuple[torch.Tensor, Metrics]]:
        M = len(models)
        place_u = [None] * M if place_u is None else place_u
        noise = [None] * M if noise is None else noise
        b, (rays_o, rays_d, viewdirs, near_v, far_v) = batch_rays(batch, cfg, rc, dev)
        n_rgb, n_rays = b["rays_o"].shape[1], rays_o.shape[0] // M
        if mesh is not None:
            rows, n_global = mesh_rows(mesh, n_rgb, n_rays - n_rgb, dev)

        def as_seam(x):
            """A seam of the whole batch's rays as a tensor, this rank's rows."""
            if x is None:
                return None
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            return x if mesh is None else x[rows]

        def member_rows(m):
            if mesh is None:
                return contextlib.nullcontext()
            gen = generators[m]
            return ray_rows(rows.to(dev if gen is None else gen.device), n_global)

        zs, draws = [], []
        for m, (net, gen) in enumerate(zip(models, generators)):
            ray = slice(m * n_rays, (m + 1) * n_rays)
            z_m = as_seam(z_vals[m])
            with member_rows(m):
                if z_m is None and occ is not None:
                    with torch.no_grad():
                        z_m = place_from_sigma(
                            sigma_fns[m], rays_o[ray], rays_d[ray], near_v[ray], far_v[ray],
                            rc.n_samples, n_candidates=occ.n_candidates,
                            floor=_floor_of(b, m, occ), generator=gen,
                            u=as_seam(place_u[m]))
                if z_m is None:
                    z_m = schedule_z_vals(rc, near_v[ray], far_v[ray], gen, is_test=False)
                zs.append(z_m)
                draws.append(net.train_eps(z_m.numel(), gen, eps[m]))
        renders = render_members(
            models, rc, rays_o, rays_d, viewdirs, torch.stack(zs).reshape(M * n_rays, -1),
            draws, is_test=False, generators=generators,
            noise=[as_seam(n) for n in noise], rows=member_rows, remat=cfg.remat)
        return [score_render(out, {k: v[m] for k, v in b.items()}, n_rgb, cfg, dev)
                for m, out in enumerate(renders)]

    return loss


def _check_replicated(grads, mesh) -> None:
    """Raise unless `grads` are equal on every data rank of `mesh`: the
    proposal's co-training runs on replicated points and an updated field
    that the all-reduce made equal, so it must not need a reduction."""
    from cfnerf_torch.parallel.mesh import DATA_AXIS

    flat = torch.cat([g.reshape(-1) for g in grads])
    first = flat.clone()
    dist.broadcast(first, src=mesh.ranks(DATA_AXIS)[0], group=mesh.group(DATA_AXIS))
    if not torch.equal(first, flat):
        raise RuntimeError("the proposal's co-training gradient differs between the "
                           "data ranks; the field or the points are not replicated")


def make_batched_cotrain(models: Sequence[torch.nn.Module], render_config: RenderConfig,
                         occ: "OccTrainConfig", proposals: Sequence[ProposalMLP],
                         prop_optimizers: Sequence[torch.optim.Adam],
                         mesh=None) -> Callable:
    """The occ stage's co-training of M members after their fields' updates
    (cfnerf_tpu/train/step.py:326-345 under JAX's vmap): cotrain(generators,
    prop_pts) -> [prop_loss], a loss a member before its step.  Member m's
    occ.cotrain_points unit-cube points are prop_pts[m] or drawn from
    generators[m] (after its step's other draws); one density query of the
    M updated fields at each member's own points (density_query_members:
    one flow-stack launch a chain for all); then each member's proposal
    fits log1p of its field's density with one step of its own Adam.
    Under a mesh each member's gradient must be equal on every data
    rank."""
    dev = next(models[0].parameters()).device
    lo = torch.tensor(occ.lo, dtype=torch.float32, device=dev)
    hi = torch.tensor(occ.hi, dtype=torch.float32, device=dev)
    density = density_query_members(models, render_config)

    def cotrain(generators: Sequence[Optional[torch.Generator]],
                prop_pts: Sequence) -> List[torch.Tensor]:
        units = []
        for gen, pts in zip(generators, prop_pts):
            if pts is None:
                pts = torch.rand((occ.cotrain_points, 3), generator=gen, device=gen.device)
            units.append(torch.as_tensor(pts, dtype=torch.float32).to(dev))
        sigmas = density(torch.stack([lo + u * (hi - lo) for u in units]))
        losses = []
        for prop, opt, unit, sigma in zip(proposals, prop_optimizers, units, sigmas):
            target = torch.log1p(sigma)
            opt.zero_grad(set_to_none=True)
            prop_loss = torch.mean((torch.log1p(prop(unit)) - target) ** 2)
            prop_loss.backward()
            if mesh is not None:
                _check_replicated([p.grad for p in prop.parameters() if p.grad is not None],
                                  mesh)
            opt.step()
            losses.append(prop_loss.detach())
        return losses

    return cotrain


class _Remat:
    """A net's train-mode unfused forward under activation checkpointing,
    for the renders make_render_rays runs (a hierarchical render's coarse
    and fine passes).  The draws (base eps, or a baseline's masks or eps) are made
    before the checkpoint (model.train_eps), so the recompute in the
    backward sees the same ones (checkpoint restores the default generators'
    state, not an explicit torch.Generator's)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, x, *, is_test, generator=None, eps=None):
        if is_test:
            return self.model(x, is_test=True, eps=eps)
        eps = self.model.train_eps(x.shape[0], generator, eps)
        return checkpoint(self.model, x, is_test=False, eps=eps, use_reentrant=False)


def make_train_step(
    model,
    render_config: RenderConfig,
    cfg: TrainConfig,
    mesh=None,
    model_fine=None,
    occ=None,
    optimizer: Optional[Tuple[torch.optim.Adam, LambdaLR]] = None,
    proposal: Optional[Tuple[ProposalMLP, torch.optim.Adam]] = None,
) -> Tuple[Callable, torch.optim.Adam]:
    """Returns (train_step, optimizer).

    train_step(batch, generator, *, z_vals=None, eps=None, eps_fine=None,
    pdf_u=None, noise=None) -> metrics takes one step in place on the
    parameters of `model` and `model_fine`.  batch holds numpy arrays or
    tensors: rays_o, rays_d, target (R, 3) and, with colmap_depth,
    depth_rays_o, depth_rays_d (D, 3), target_depth (D,).  The generator
    makes every draw of the step; the keywords inject them instead, as
    `make_render_rays` describes.  Metrics: loss, loss_nll, loss_entropy,
    [depth_loss], [loss_nll0], mse, psnr, detached, on the model's device.

    With render_config.n_importance > 0 the step is hierarchical (nerf-
    pytorch semantics, cfnerf_tpu/train/step.py:262-304): the fine pass
    runs through `model_fine` (or `model` without one), the entropy sums
    both passes, and the coarse render's loss `loss_nll0` (KDE NLL, or MSE
    in 'mse' mode) is added to the loss.  Adam updates both networks.

    The two halves are callable apart, so that the gradients can be read
    before the update: train_step.loss_fn(batch, generator, *, z_vals, eps,
    eps_fine, pdf_u, noise, place_u) -> (loss, metrics) renders and scores
    (this rank's share under a mesh); train_step.update() takes the
    optimizer step on the gradients in .grad (under a mesh, reduced first)
    and advances the schedule.

    With `occ` (OccTrainConfig; no fine pass, ValueError otherwise) the step
    renders at proposal-placed depths: placement without gradient, its
    stratified u from the generator first (the keyword `place_u` (R + D, N)
    injects them), the floor batch["occ_floor"] when the batch has one, else
    occ.floor.  After the field's update, train_step.cotrain(generator, *,
    prop_pts) fits the proposal (train_step.proposal, its own Adam
    train_step.prop_optimizer) to log1p of the updated field's test-mode
    density at occ.cotrain_points points of the unit cube mapped into the
    aabb, drawn from the generator after the step's other draws (`prop_pts`
    injects them), and the step's metrics gain prop_loss.  The proposal starts
    from ProposalMLP's seeded init; train_step.install_proposal(prop or
    state_dict) loads distilled weights and restarts its Adam (JAX's
    _wrap_state), at the stage boundary.

    `optimizer` carries an (Adam, schedule) pair over from an earlier step
    (its train_step.optimizer and train_step.scheduler) instead of a fresh
    one: the training loop's stages (another K, the occ stage on or off)
    build a step each over the same parameters, and JAX's loop carries one
    opt_state through all of them, Adam's moments and the lr count
    included.  The pair must hold exactly these nets' parameters.
    `proposal` carries the occ stage's (ProposalMLP, Adam) pair over the
    same way (an earlier occ step's train_step.proposal and
    train_step.prop_optimizer): JAX's opt_state holds the proposal too, so
    it survives a K boundary inside the occ stage.

    On a CUDA device, where graph_refusal says so and Adam is capturable
    (make_optimizer's, carried or not), train_step is one CUDA graph
    (train/graph.py), captured at its first call (a warm-up forward and
    backward first, no update) and replayed at every call whose batch and
    seams have the captured shapes and whose generator is the captured one;
    another call runs eagerly on the same Adam.  The draws that no seam
    hands in are made inside the graph from the generator, which the graph
    registers: a replay draws what the eager step draws from it, in the
    same order, and advances it as far.

    `mesh` (parallel/mesh.py: a (data, model) mesh, or an (ensemble, data)
    one for a member's step) makes the step one rank's share of a data-
    parallel step: batch holds this rank's rows (parallel.mesh.shard_batch)
    and the nets are replicated or tensor-parallel (shard_params_tp).  Every
    per-ray draw (jitter, pdf_u, noise, place_u, dropout masks) is made at
    the whole batch's shape and cut to this rank's rows, rgb rays then depth
    rays; the seams z_vals, pdf_u, noise and place_u take the whole batch's
    arrays and are cut the same way (eps and eps_fine are shared by every
    ray and pass whole).  update() all-reduces the mean of every gradient
    over the data axis, in one flat bucket, before Adam's step, so .grad
    holds the global gradient after train_step; the metrics are the global
    means (psnr from the global mse; train_step.global_metrics takes a
    rank's metrics to them).  The occ co-training fits the
    proposal on points drawn alike on every rank, and raises unless its
    gradient is equal on every data rank.
    """
    if model_fine is not None and render_config.n_importance == 0:
        raise ValueError("a fine network needs render_config.n_importance > 0")
    if cfg.loss_mode not in ("kde", "mse"):
        raise ValueError(f"loss_mode must be 'kde' or 'mse', got {cfg.loss_mode!r}")
    if occ is not None and render_config.n_importance > 0:
        raise ValueError("occ training is incompatible with a "
                         "hierarchical fine pass (one placement owner)")

    nets = [model] if model_fine is None else [model, model_fine]
    params = [p for net in nets for p in net.parameters()]
    if optimizer is None:
        optimizer, scheduler = make_optimizer(params, cfg)
    else:
        optimizer, scheduler = optimizer
        held = [p for group in optimizer.param_groups for p in group["params"]]
        if {id(p) for p in held} != {id(p) for p in params} or len(held) != len(params):
            raise ValueError("the carried optimizer holds other parameters than these nets")
    wrap = _Remat if cfg.remat else (lambda net: net)
    render_rays = make_render_rays(
        wrap(model), render_config,
        model_fine=None if model_fine is None else wrap(model_fine))

    dev = next(model.parameters()).device
    if occ is not None:
        if proposal is None:
            net = ProposalMLP(occ.prop_width, occ.prop_depth, occ.prop_multires, device=dev)
            proposal = (net, torch.optim.Adam(net.parameters(), lr=occ.prop_lr,
                                              betas=(0.9, 0.999), eps=1e-8))
        proposal, prop_optimizer = proposal
        occ_lo = torch.tensor(occ.lo, dtype=torch.float32, device=dev)
        occ_hi = torch.tensor(occ.hi, dtype=torch.float32, device=dev)
        sigma_fn = make_proposal_sigma_fn(proposal, occ_lo, occ_hi)
        # the ensemble's member-batched co-training at one member
        batched_cotrain = make_batched_cotrain([model], render_config, occ, [proposal],
                                               [prop_optimizer], mesh)
    # a step without a fine pass (NeRFFlows of any family, fused or
    # unfused, or a baseline; placed or not, remat or not) is the
    # ensemble's member-batched loss at one member: one code path for both
    batched = (make_batched_loss([model], render_config, cfg, mesh, occ,
                                 None if occ is None else [proposal])
               if batched_step_refusal([model], render_config, cfg, model_fine, occ) is None
               else None)

    if mesh is not None:
        from cfnerf_torch.parallel.mesh import DATA_AXIS, mean_over

        n_data = mesh.shape[DATA_AXIS]
        data_group = mesh.group(DATA_AXIS)

    def _loss(batch: Mapping, generator: Optional[torch.Generator] = None, *,
              z_vals=None, eps=None, eps_fine=None, pdf_u=None,
              noise=None, place_u=None) -> Tuple[torch.Tensor, Metrics]:
        b, (rays_o, rays_d, viewdirs, near_v, far_v) = batch_rays(batch, cfg, render_config,
                                                                 dev)
        if occ is not None and z_vals is None:
            with torch.no_grad():
                z_vals = place_from_sigma(
                    sigma_fn, rays_o, rays_d, near_v, far_v, render_config.n_samples,
                    n_candidates=occ.n_candidates, floor=b.get("occ_floor", occ.floor),
                    generator=generator, u=place_u)
        out = render_rays(rays_o, rays_d, viewdirs, near_v, far_v, generator,
                          is_test=False, z_vals=z_vals, eps=eps, eps_fine=eps_fine,
                          pdf_u=pdf_u, noise=noise)
        return score_render(out, b, b["rays_o"].shape[0], cfg, dev)

    def loss_fn(batch: Mapping, generator: Optional[torch.Generator] = None, *,
                z_vals=None, eps=None, eps_fine=None, pdf_u=None,
                noise=None, place_u=None) -> Tuple[torch.Tensor, Metrics]:
        if batched is not None:  # no fine pass: no eps_fine or pdf_u to draw
            one = {k: torch.as_tensor(v)[None] for k, v in batch.items()}
            return batched(one, [generator], z_vals=[z_vals], eps=[eps], place_u=[place_u],
                           noise=[None if noise is None else noise[0]])[0]
        if mesh is None:
            return _loss(batch, generator, z_vals=z_vals, eps=eps, eps_fine=eps_fine,
                         pdf_u=pdf_u, noise=noise, place_u=place_u)
        n_depth = len(batch["depth_rays_o"]) if cfg.colmap_depth else 0
        rows, n_global = mesh_rows(mesh, len(batch["rays_o"]), n_depth,
                                   dev if generator is None else generator.device)

        def mine(x):
            if x is None:
                return None
            if isinstance(x, (tuple, list)):
                return type(x)(mine(v) for v in x)
            x = torch.as_tensor(x)
            return x[rows.to(x.device)]

        with ray_rows(rows, n_global):
            return _loss(batch, generator, z_vals=mine(z_vals), eps=eps, eps_fine=eps_fine,
                         pdf_u=mine(pdf_u), noise=mine(noise), place_u=mine(place_u))

    refusal = graph_refusal(model, model_fine, render_config, cfg, mesh, occ)
    if refusal is None and not all(g.get("capturable") and torch.is_tensor(g["lr"])
                                   for g in optimizer.param_groups):
        refusal = "Adam is not capturable with a device lr"
    graph = None if refusal is not None else StepGraph(
        lambda batch, gens, seams: loss_fn(batch, gens[0], **seams), [optimizer], dev)

    def reduce_grads() -> None:
        """The mean gradient over the data axis, in place, one all-reduce."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data_group)
        flat.div_(n_data)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def global_metrics(metrics: Metrics) -> Metrics:
        """The data axis's mean of each metric; psnr of the mean mse."""
        keys = [k for k in metrics if k not in ("psnr", "prop_loss")]
        out = dict(metrics)
        out.update(zip(keys, mean_over([metrics[k] for k in keys], mesh)))
        out["psnr"] = mse2psnr(out["mse"])
        return out

    def update() -> None:
        if mesh is not None:
            reduce_grads()
        optimizer.step()
        scheduler.step()

    def cotrain(generator: Optional[torch.Generator], *, prop_pts=None) -> torch.Tensor:
        """One Adam step of the proposal towards log1p of the field's current
        density; returns the loss before it."""
        return batched_cotrain([generator], [prop_pts])[0]

    def train_step(batch: Mapping, generator: Optional[torch.Generator], *,
                   z_vals=None, eps=None, eps_fine=None, pdf_u=None,
                   noise=None, place_u=None, prop_pts=None) -> Metrics:
        # the phases' spans (utils/trace.py), with none around the whole
        # step: each is then the outermost host event of its part of it
        if graph is not None:
            with span("cfnerf.train.stage"):
                staged = graph.stage(batch, (generator,), dict(
                    z_vals=z_vals, eps=eps, eps_fine=eps_fine, pdf_u=pdf_u, noise=noise))
            if staged:
                with span("cfnerf.train.replay"):
                    metrics = graph.replay()
                with span("cfnerf.train.update"):
                    scheduler.step()
                return metrics
            count("train.graph_eager")  # another call than the captured one
        with span("cfnerf.train.zero_grad"):
            optimizer.zero_grad(set_to_none=True)
        with span("cfnerf.train.forward"):
            loss, metrics = loss_fn(batch, generator, z_vals=z_vals, eps=eps,
                                    eps_fine=eps_fine, pdf_u=pdf_u, noise=noise,
                                    place_u=place_u)
        with span("cfnerf.train.backward"):
            loss.backward()
        with span("cfnerf.train.update"):
            update()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:
                metrics = global_metrics(metrics)
        if occ is not None:
            with span("cfnerf.train.cotrain"):
                metrics["prop_loss"] = cotrain(generator, prop_pts=prop_pts)
        return metrics

    train_step.loss_fn = loss_fn
    train_step.update = update
    train_step.graph_refusal = refusal
    if mesh is not None:
        train_step.global_metrics = global_metrics
    train_step.optimizer = optimizer
    train_step.scheduler = scheduler
    if occ is not None:
        def install_proposal(prop) -> None:
            """Load distilled weights (a ProposalMLP or its state_dict) and
            restart the proposal's Adam."""
            state = prop.state_dict() if isinstance(prop, torch.nn.Module) else prop
            proposal.load_state_dict(state)
            prop_optimizer.state.clear()

        train_step.cotrain = cotrain
        train_step.proposal = proposal
        train_step.prop_optimizer = prop_optimizer
        train_step.install_proposal = install_proposal
    return train_step, optimizer


def make_train_loop(
    model,
    render_config: RenderConfig,
    cfg: TrainConfig,
    mesh=None,
    n_inner: int = 10,
    model_fine=None,
    occ=None,
    optimizer: Optional[Tuple[torch.optim.Adam, LambdaLR]] = None,
    proposal: Optional[Tuple[ProposalMLP, torch.optim.Adam]] = None,
) -> Tuple[Callable, torch.optim.Adam]:
    """Returns (train_loop, optimizer).  train_loop(batches, generator, *,
    after_step=None) takes n_inner steps over batches stacked on a leading
    (n_inner, ...) axis and returns the metrics stacked the same way;
    after_step(j, metrics), where given, runs after inner step j, its
    gradients still in .grad.  `optimizer` and `proposal` as in
    make_train_step."""
    train_step, optimizer = make_train_step(model, render_config, cfg, mesh,
                                            model_fine, occ, optimizer, proposal)

    def train_loop(batches: Mapping, generator: Optional[torch.Generator], *,
                   after_step: Optional[Callable[[int, Metrics], None]] = None) -> Metrics:
        steps = []
        for j in range(n_inner):
            steps.append(train_step({k: v[j] for k, v in batches.items()}, generator))
            if after_step is not None:
                after_step(j, steps[-1])
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    train_loop.optimizer = optimizer
    train_loop.scheduler = train_step.scheduler
    if occ is not None:
        train_loop.install_proposal = train_step.install_proposal
        train_loop.proposal = train_step.proposal
        train_loop.prop_optimizer = train_step.prop_optimizer
    return train_loop, optimizer
