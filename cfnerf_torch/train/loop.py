"""The training loop; counterpart of cfnerf_tpu/train/loop.py (the
reference's train(), run_nerf_uncertainty_NF.py:722-1198): data load ->
splits -> run dir + args snapshot -> model build / resume -> (render_only)
-> ray precompute -> the loop with loss, Adam, lr decay, logging,
checkpoints, test-set renders and videos.

  * --k_schedule 'K:step,...': a piecewise-constant K over global steps
    (parse_k_schedule, k_for_step).  K is no parameter axis: each stage
    trains the same parameters through a view of the model at its K
    (`_at_k`), and one Adam with its lr schedule runs on across every
    stage, as JAX's loop carries one opt_state;
  * --occ_train: proposal-placed training from --occ_train_from until
    --occ_train_until, the proposal distilled from the current field at the
    boundary; --occ_floor_anneal: its placement floor, linear from
    --occ_floor_start to --occ_floor (occ_floor_for_step), fed to the step
    as batch["occ_floor"];
  * the loss follows --model (loss_mode_for_model): MSE for nerf and
    nerf_dropout, the KDE NLL for the flow model and nerf_wild;
  * the step's metrics stay on the device and are read at i_print only, as
    the JAX loop's device_get, so the loop adds no synchronisation a step;
  * --profile_dir / --profile_start / --profile_steps: a torch.profiler
    window, its Chrome trace written into profile_dir, with the cfnerf.*
    spans of every thread (utils/trace.py);
  * --debug_nans / --debug_infs: FloatingPointError at the first step whose
    loss or gradients hold a NaN / an inf, inner steps of --n_inner
    included (a host read each step, under those flags only);
  * --mesh_devices N (0: every visible card, 1 on the CPU) and
    --model_parallel P: N ranks (parallel/mesh.py:launch; NCCL, one card a
    rank, or gloo on the CPU), an (N / P, P) (data, model) mesh, each step's
    batch sharded over the data axis, the trunk's widths over the model
    axis with P > 1 (shard_params_tp); the renders split each tile's rays
    over the data axis.  Every rank reads the resumed checkpoint; rank 0
    alone writes checkpoints, metrics, args.txt, images and videos.  With N
    = P = 1 no process group is made: the one-device path.

Test-mode renders (the val stream, i_img, the test set, the video, render
only) run at --K_samples with the model's fixed eps.  The loop runs on the
CUDA device unless train(args, device="cpu").
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cfnerf_torch.data.blender import load_blender_data
from cfnerf_torch.data.image_io import imwrite_png
from cfnerf_torch.data.llff import load_colmap_depth, load_llff_data
from cfnerf_torch.data.prefetch import BatchPrefetcher
from cfnerf_torch.data.sampler import (
    N_DEPTH,
    DepthRayBatcher,
    RayBatcher,
    SingleImageSampler,
    lf_scene_splits,
    precompute_depth_rays,
    precompute_rays,
)
from cfnerf_torch.models.factory import create_nerf, loss_mode_for_model
from cfnerf_torch.ops.metrics import img2mse, mse2psnr, std_over_k, to8b
from cfnerf_torch.parallel.mesh import (
    check_mesh_size,
    check_tensor_parallel,
    create_mesh,
    full_optimizer_state,
    full_state_dict,
    is_writer,
    launch,
    mean_over,
    rank_device,
    replicate,
    shard_batch,
    shard_params_tp,
    shard_stacked_batch,
)
from cfnerf_torch.render.renderer import make_render_rays, prepare_rays, render_image
from cfnerf_torch.train import checkpoint as ckpt
from cfnerf_torch.train.logging import MetricsLogger
from cfnerf_torch.train.loss import kde_nll
from cfnerf_torch.train.step import (
    OccTrainConfig,
    TrainConfig,
    make_optimizer,
    make_train_loop,
    make_train_step,
)
from cfnerf_torch.utils.config import warn_ignored_flags
from cfnerf_torch.utils.device import DeviceLike, resolve_device


def parse_k_schedule(spec: str) -> List[Tuple[int, int]]:
    """Parse 'K:step,K:step,...' (e.g. '8:0,16:2000,32:5000') into a sorted
    [(start_step, K), ...].  Raises ValueError for a malformed item, a
    duplicate start step, no stage at step 0, or a K below 2 (the KDE
    bandwidth needs two draws)."""
    stages = []
    for part in spec.split(","):
        try:
            k_str, step_str = part.split(":")
            stages.append((int(step_str), int(k_str)))
        except ValueError:
            raise ValueError(
                f"bad --k_schedule entry {part!r}; expected 'K:start_step' "
                "items, e.g. '8:0,16:2000,32:5000'"
            )
    stages.sort()
    starts = [s for s, _ in stages]
    if len(set(starts)) != len(starts):
        # a tuple sort would let the larger K win a duplicated start silently
        dup = sorted({s for s in starts if starts.count(s) > 1})
        raise ValueError(
            f"--k_schedule has duplicate start_step value(s) {dup}; each "
            "stage must begin at a distinct step"
        )
    if stages[0][0] != 0:
        raise ValueError("--k_schedule must define a stage starting at step 0")
    if any(k < 2 for _, k in stages):
        raise ValueError("--k_schedule K values must be >= 2 (KDE needs "
                         "multiple samples for its bandwidth)")
    return stages


def k_for_step(stages: List[Tuple[int, int]], step: int) -> int:
    """K of the last stage that starts at or before `step`."""
    k = stages[0][1]
    for s, kk in stages:
        if step >= s:
            k = kk
    return k


def occ_floor_for_step(step: int, occ_from: int, anneal: int,
                       floor_start: float, floor_end: float) -> float:
    """Linear placement floor of the occ stage: floor_start at the boundary
    `occ_from`, floor_end once `anneal` steps have passed, clamped on both
    sides; floor_end when anneal <= 0.  Indexed by global step, so a resumed
    run lands at the right point."""
    if anneal <= 0:
        return floor_end
    t = min(max((step - occ_from) / anneal, 0.0), 1.0)
    return floor_start + (floor_end - floor_start) * t


def load_dataset(args) -> dict:
    """Dataset dispatch (reference :730-801): an LLFF capture (with
    --colmap_depth its COLMAP sparse depths; NDC near/far 0/1, or with
    --no_ndc 0.9 x the nearest and 1.0 x the farthest bound) or a Blender
    scene (near 2, far 6; --white_bkgd blends RGBA onto white).  Returns a
    dict of images (N, H, W, 3), poses (N, 3, 4), render_poses, H, W, focal,
    i_train, i_val, i_val_internal, near, far and depth_gts (None without
    COLMAP depth), all numpy / Python values."""
    if args.dataset_type == "llff":
        depth_gts = None
        if args.colmap_depth:
            depth_gts = load_colmap_depth(args.datadir, factor=args.factor, bd_factor=0.75)
        images, poses, bds, render_poses, i_test = load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify,
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_train, i_val, i_val_internal = lf_scene_splits(
            args.dataname, images.shape[0], args.llffhold, i_test=i_test
        )
        if args.no_ndc:
            near = float(bds.min()) * 0.9
            far = float(bds.max()) * 1.0
        else:
            near, far = 0.0, 1.0
    elif args.dataset_type == "blender":
        images, poses, render_poses, hwf, i_split = load_blender_data(
            args.datadir, args.half_res, args.testskip
        )
        i_train, i_val, i_test = [list(s) for s in i_split]
        i_val_internal = list(i_val)
        near, far = 2.0, 6.0
        if args.white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]
        poses = poses[:, :3, :4]
        depth_gts = None
    else:
        raise ValueError(f"unknown dataset_type {args.dataset_type}")

    H, W, focal = hwf
    return dict(
        images=images.astype(np.float32),
        poses=poses.astype(np.float32),
        render_poses=np.asarray(render_poses, dtype=np.float32),
        H=int(H), W=int(W), focal=float(focal),
        i_train=i_train, i_val=i_val, i_val_internal=i_val_internal,
        near=near, far=far, depth_gts=depth_gts,
    )


def _snapshot_args(args, rundir: str) -> None:
    """Write rundir/args.txt (every flag as `name = value`, sorted; an unset
    flag as the literal None, which the parser reads back as None) and, with
    --config, a copy of the config file as rundir/config.txt."""
    os.makedirs(rundir, exist_ok=True)
    with open(os.path.join(rundir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    if getattr(args, "config", None):
        with open(args.config) as src, open(os.path.join(rundir, "config.txt"), "w") as f:
            f.write(src.read())


class ValEarlyStop:
    """--early_stop_val: stop once val/psnr has not improved by `min_delta`
    dB for `patience` consecutive val evaluations (i_print cadence)."""

    def __init__(self, patience: int, min_delta: float = 0.01):
        if patience <= 0:
            raise ValueError(f"patience must be > 0, got {patience}")
        self.patience = patience
        self.min_delta = min_delta
        self.best = -np.inf
        self.stale = 0

    def update(self, val_psnr: float) -> bool:
        """Record one val evaluation; True means stop now."""
        if val_psnr > self.best + self.min_delta:
            self.best = float(val_psnr)
            self.stale = 0
        else:
            self.stale += 1
        return self.stale >= self.patience


def _save_video(frames: np.ndarray, path: str, fps: int = 30) -> None:
    """Write a spiral / test video: an mp4 through imageio (with an ffmpeg
    binary) where it imports, as the JAX package writes it; otherwise the
    last rung of JAX's ladder, the frames as PNGs through imwrite_png into
    <path without .mp4>/NNN.png.  (JAX's middle rung, OpenCV's mp4v, is
    left out: the port's frames stay PNGs that read back bitwise.)"""
    frames8 = to8b(frames)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames8, fps=fps, quality=8)
        return
    except Exception as e:
        ffmpeg_err = e
    base = os.path.splitext(path)[0]
    os.makedirs(base, exist_ok=True)
    for i, fr in enumerate(frames8):
        imwrite_png(os.path.join(base, f"{i:03d}.png"), fr)
    print(f"mp4 export unavailable (ffmpeg: {ffmpeg_err}); wrote PNG frames to {base}/")


def render_path(
    render_poses: np.ndarray,
    scene: dict,
    args,
    render_rays_fn,
    savedir: Optional[str] = None,
    render_factor: int = 0,
    device: DeviceLike = None,
    mesh=None,
):
    """Render a pose path in test mode (the reference's render_path,
    :173-244, with its crashes fixed), each view through render_image in
    --chunk tiles (over `mesh`'s data axis where given); with `savedir`
    write NNN.png (the mean) and NNN_std.png (the std over K, divided by
    its maximum).

    Returns numpy (rgbs_mean (P,H,W,3), disps_mean (P,H,W), stds (P,H,W,3))."""
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    if render_factor != 0:
        H, W, focal = H // render_factor, W // render_factor, focal / render_factor

    rgbs, disps, stds = [], [], []
    for i, c2w in enumerate(np.asarray(render_poses)):
        out = render_image(
            render_rays_fn, c2w[:3, :4], H=H, W=W, focal=focal,
            ndc=(args.dataset_type == "llff" and not args.no_ndc),
            use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"],
            tile=args.chunk, device=device, mesh=mesh,
        )
        rgbs.append(out["rgb_map"].mean(-1).cpu().numpy())  # (H, W, 3, K) -> (H, W, 3)
        disps.append(out["disp_map"].mean(-1).cpu().numpy())
        stds.append(std_over_k(out["rgb_map"]).cpu().numpy())
        if savedir is not None:
            imwrite_png(os.path.join(savedir, f"{i:03d}.png"), to8b(rgbs[-1]))
            imwrite_png(os.path.join(savedir, f"{i:03d}_std.png"),
                        to8b(stds[-1] / (stds[-1].max() + 1e-8)))
    return np.stack(rgbs), np.stack(disps), np.stack(stds)


def _at_k(net, k: int):
    """`net` drawing k samples (net.at_k: a shallow copy that shares every
    parameter, its own test-mode draws rebuilt at k from the same seed, as
    JAX's model.clone(k_samples=k) does); the occ stage's co-training target
    reads the field in test mode at the stage's K.  The loop's test-mode
    renders use `net` itself."""
    if net is None or net.k_samples == k:
        return net
    return net.at_k(k)


def _crossed(prev: int, cur: int, cadence: int) -> bool:
    return cadence > 0 and (prev // cadence) != (cur // cadence)


def _check_finite(step: int, loss: torch.Tensor, params, nans: bool, infs: bool) -> None:
    """--debug_nans / --debug_infs: raise at the first NaN / inf in the loss
    or a gradient of this step (reads them on the host)."""
    values = [loss] + [p.grad for p in params if p.grad is not None]
    if nans and any(bool(torch.isnan(v).any()) for v in values):
        raise FloatingPointError(f"NaN in the loss or a gradient at step {step} (--debug_nans)")
    if infs and any(bool(torch.isinf(v).any()) for v in values):
        raise FloatingPointError(f"inf in the loss or a gradient at step {step} (--debug_infs)")


def mesh_devices(args, device: DeviceLike = None) -> int:
    """--mesh_devices, where 0 means every device: the group's ranks inside
    a launch, else the visible CUDA devices, or 1 on the CPU."""
    n = int(getattr(args, "mesh_devices", 0) or 0)
    if n > 0:
        return n
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.device("cuda" if device is None else device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def mesh_plan(args, device: DeviceLike = None) -> Tuple[int, int]:
    """(devices, model_parallel) of --mesh_devices / --model_parallel.
    Raises JAX's ValueError when the devices do not divide by
    model_parallel, and ValueError for a model axis with the trunk
    kernels."""
    n = mesh_devices(args, device)
    mp = max(1, int(getattr(args, "model_parallel", 1) or 1))
    check_mesh_size(n, mp)
    check_tensor_parallel(mp, getattr(args, "trunk_impl", "xla"))
    return n, mp


def needs_launch(n_devices: int) -> bool:
    """More than one device asked for, and no process group yet."""
    return n_devices > 1 and not dist.is_initialized()


def check_n_rand(n_rand: int, n_data: int) -> None:
    if n_rand % n_data != 0:
        raise ValueError(
            f"N_rand={n_rand} must be divisible by the mesh data axis ({n_data})"
        )


def _train_rank(rank: int, args, device: DeviceLike) -> None:
    train(args, device=rank_device(device, rank))


def _to_device(batch: dict, dev: torch.device) -> dict:
    """Numpy batch -> tensors on `dev` (pinned and copied without blocking
    on the card)."""
    if dev.type == "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            dev, non_blocking=True) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def train(args, device: DeviceLike = None) -> None:
    """Run the experiment of `args` (the flags of utils/config.py); every
    branch of the JAX package's train(): --render_only (with --occ_eval,
    --render_test), batched rays or --no_batching with precrop, the
    internal-val stream, COLMAP depth, the K schedule and the occ stage,
    --n_inner, the cadences i_weights / i_print / i_img / i_testset /
    i_video, --early_stop_val.  On the CUDA device unless device="cpu".
    More than one device (--mesh_devices, --model_parallel): the run is
    launched on that many ranks, each calling train again inside the group
    (mesh_plan, parallel/mesh.py:launch)."""
    n_devices, mp = mesh_plan(args, device)
    if needs_launch(n_devices):
        if not args.render_only:
            check_n_rand(args.N_rand, n_devices // mp)
        launch(_train_rank, n_devices, args, device, device=device)
        return
    dev = resolve_device(device)
    warn_ignored_flags(args)
    debug_nans = bool(getattr(args, "debug_nans", False))
    debug_infs = bool(getattr(args, "debug_infs", False))

    scene = load_dataset(args)
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    print(f"Loaded {args.dataset_type} {scene['images'].shape} "
          f"hwf=({H},{W},{focal:.1f}) near/far=({scene['near']:.3f},{scene['far']:.3f})")
    print("TRAIN views are", scene["i_train"])
    print("VAL views are", scene["i_val"])

    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    writer = is_writer()
    if writer:
        _snapshot_args(args, rundir)

    model, model_fine, render_config, start = create_nerf(args, dev)
    nets = [model] if model_fine is None else [model, model_fine]
    print(f"model params: {sum(p.numel() for net in nets for p in net.parameters()):,}")
    mesh = None
    if dist.is_initialized():
        mesh = create_mesh(n_devices, model_parallel=mp)
        for net in nets:
            replicate(mesh, net)
            shard_params_tp(mesh, net)
        if mp > 1:
            print(f"tensor-parallel trunk over mesh {dict(mesh.shape)}")
    n_data = 1 if mesh is None else mesh.shape["data"]
    params = [p for net in nets for p in net.parameters()]

    # test-mode renderer (perturb off comes from is_test; fixed-eps draws)
    render_rays_test = make_render_rays(model, render_config, model_fine)

    # --- render_only shortcut (reference :833-851) ---
    if args.render_only:
        print("RENDER ONLY")
        occ_serve = int(getattr(args, "occ_eval", 0) or 0)
        if occ_serve > 0 and model_fine is None:
            from cfnerf_torch.ops.occupancy import wrap_renderer_for_serving

            rc_serve = dataclasses.replace(render_config, n_samples=occ_serve)
            render_rays_test = wrap_renderer_for_serving(
                make_render_rays(model, rc_serve), args, scene, model, rc_serve)
            print(f"occupancy serving: N={occ_serve} placed samples/ray "
                  f"(trained at N={render_config.n_samples})")
        render_poses = (
            scene["poses"][scene["i_val"]] if args.render_test else scene["render_poses"]
        )
        tag = "test" if args.render_test else "path"
        testsavedir = os.path.join(rundir, f"renderonly_{tag}_{start:06d}")
        if writer:
            os.makedirs(testsavedir, exist_ok=True)
        rgbs, _, _ = render_path(
            render_poses, scene, args, render_rays_test,
            savedir=testsavedir if writer else None,
            render_factor=args.render_factor, device=dev, mesh=mesh,
        )
        if writer:
            _save_video(rgbs, os.path.join(testsavedir, "video.mp4"))
        print("Done rendering", testsavedir)
        return

    # --- ray precompute (reference :859-919) ---
    check_n_rand(args.N_rand, n_data)
    use_batching = not args.no_batching
    if use_batching:
        rays_rgb_train = precompute_rays(
            scene["images"], scene["poses"], focal, scene["i_train"], seed=args.seed
        )
        print("rays_rgb_train:", rays_rgb_train.shape)
        train_batcher = RayBatcher(rays_rgb_train, args.N_rand, seed=args.seed,
                                   mesh_divisor=n_data)
    else:
        # --no_batching: sample from one image per step with precrop warmup
        train_batcher = SingleImageSampler(
            scene["images"], scene["poses"], focal, scene["i_train"], args.N_rand,
            precrop_iters=args.precrop_iters, precrop_frac=args.precrop_frac,
            seed=args.seed,
        )

    # the internal-val ray stream: a shuffled held-out batch rendered in
    # test mode at every i_print (the reference builds it, :877-885, and
    # never consumes it)
    val_batcher = None
    if use_batching and len(scene["i_val_internal"]) > 0:
        rays_rgb_val = precompute_rays(
            scene["images"], scene["poses"], focal, scene["i_val_internal"],
            seed=args.seed + 1,
        )
        if rays_rgb_val.shape[0] >= args.N_rand:
            print("rays_rgb_val:", rays_rgb_val.shape)
            val_batcher = RayBatcher(rays_rgb_val, args.N_rand, seed=args.seed + 1,
                                     mesh_divisor=n_data)

    depth_batcher = None
    if args.colmap_depth and not use_batching:
        # the reference crashes inside the loss here (KeyError on the depth
        # batch); fail clearly at config time instead
        raise ValueError(
            "--colmap_depth requires the batching path; drop --no_batching "
            "(the reference's depth supervision only exists for batched rays, "
            "run_nerf_uncertainty_NF.py:855,888-912)"
        )
    if args.colmap_depth and use_batching:
        rays_depth = precompute_depth_rays(
            scene["depth_gts"], scene["poses"], H, W, focal, scene["i_train"],
            seed=args.seed,
        )
        print("rays_depth:", rays_depth.shape)
        depth_batcher = DepthRayBatcher(rays_depth, N_DEPTH, seed=args.seed)

    def shard(batch):
        return batch if mesh is None else shard_batch(mesh, batch)

    # --- train step ---
    tc = TrainConfig(
        H=H, W=W, focal=focal,
        ndc=(args.dataset_type == "llff" and not args.no_ndc),
        near=scene["near"], far=scene["far"],
        k_samples=args.K_samples,
        lrate=args.lrate, lrate_decay=args.lrate_decay,
        start_step=start,
        beta1=args.beta1,
        colmap_depth=args.colmap_depth, depth_lambda=args.depth_lambda,
        loss_mode=loss_mode_for_model(getattr(args, "model", None)),
    )

    def val_metrics(batch):
        """Test-mode mse, psnr and KDE NLL of a held-out ray batch (its
        shard's, averaged over the data axis, under a mesh)."""
        with torch.inference_mode():
            b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in shard(batch).items()}
            ro, rd, vd, near_v, far_v = prepare_rays(
                b["rays_o"], b["rays_d"], H=H, W=W, focal=focal, ndc=tc.ndc,
                use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"])
            out = render_rays_test(ro, rd, vd, near_v, far_v, None, is_test=True)
            mse = img2mse(out["rgb_map"].mean(-1), b["target"])
            nll = kde_nll(out["rgb_map"], b["target"], args.K_samples)
            if mesh is not None:
                mse, nll = mean_over([mse, nll], mesh)
            return float(mse), float(mse2psnr(mse)), float(nll)

    # --- occ stage config (proposal-placed training, step.OccTrainConfig) ---
    occ_n = int(getattr(args, "occ_train", 0) or 0)
    occ_from = int(getattr(args, "occ_train_from", 0) or 0)
    occ_until = int(getattr(args, "occ_train_until", 0) or 0)
    occ_anneal = int(getattr(args, "occ_floor_anneal", 0) or 0)
    occ_floor_start = float(getattr(args, "occ_floor_start", 1.0))
    occ_cfg = None
    if occ_n > 0:
        from cfnerf_torch.ops.occupancy import aabb_from_scene

        if args.N_importance > 0:
            raise ValueError("--occ_train is incompatible with --N_importance "
                             "(one placement owner for the z axis)")
        occ_lo, occ_hi = (t.cpu().numpy() for t in aabb_from_scene(scene, args, dev))
        occ_cfg = OccTrainConfig(
            lo=tuple(float(x) for x in occ_lo), hi=tuple(float(x) for x in occ_hi),
            n_candidates=args.occ_candidates, floor=args.occ_floor,
        )
        if occ_until > 0 and occ_until <= occ_from:
            raise ValueError(f"--occ_train_until {occ_until} must be > "
                             f"--occ_train_from {occ_from}")
        if occ_from <= max(start, 0) and occ_anneal <= 0:
            print("WARNING: --occ_train with no dense warmup "
                  f"(--occ_train_from {occ_from} <= start {start}): the "
                  "proposal will be distilled from the current (possibly "
                  "untrained) field; warm up with a few thousand dense "
                  "steps (EVAL_r07) or anneal the floor from uniform "
                  "(--occ_floor_anneal)", flush=True)
        until_s = f" until step {occ_until}" if occ_until > 0 else ""
        anneal_s = (f", floor {occ_floor_start}->{args.occ_floor} over "
                    f"{occ_anneal} steps" if occ_anneal > 0
                    else f", floor {args.occ_floor}")
        print(f"occ training: N={occ_n} proposal-placed samples/ray from "
              f"step {occ_from}{until_s} (dense N={args.N_samples} "
              f"otherwise){anneal_s}, C={args.occ_candidates}, "
              f"aabb {occ_lo.round(3)}..{occ_hi.round(3)}")

    k_stages = None
    if getattr(args, "k_schedule", ""):
        k_stages = parse_k_schedule(args.k_schedule)
        if k_stages[-1][1] != args.K_samples:
            print(
                f"WARNING: --k_schedule ends at K={k_stages[-1][1]} but "
                f"--K_samples={args.K_samples}; eval/test renders use "
                f"K={args.K_samples}"
            )

    n_inner = max(1, getattr(args, "n_inner", 1))
    carried = make_optimizer(params, tc)  # one Adam and schedule for every stage
    optimizer = carried[0]
    carried_prop = None  # the occ stages' one (proposal, its Adam), once built
    stages = {}

    def stage(k: int, occ_on: bool):
        """The dispatch for K = k, with or without proposal-placed samples:
        a step (n_inner == 1) or a loop of n_inner steps, over the same
        parameters and the carried optimizer; every occ stage also over the
        same proposal and its Adam."""
        nonlocal carried_prop
        key = (k, occ_on)
        if key not in stages:
            rc_k, occ_arg = render_config, None
            if occ_on:
                rc_k, occ_arg = dataclasses.replace(render_config, n_samples=occ_n), occ_cfg
            m_k, fine_k = _at_k(model, k), _at_k(model_fine, k)
            tc_k = dataclasses.replace(tc, k_samples=k)
            if n_inner > 1:
                fn, _ = make_train_loop(m_k, rc_k, tc_k, mesh=mesh, n_inner=n_inner,
                                        model_fine=fine_k, occ=occ_arg, optimizer=carried,
                                        proposal=carried_prop)
            else:
                fn, _ = make_train_step(m_k, rc_k, tc_k, mesh=mesh, model_fine=fine_k,
                                        occ=occ_arg, optimizer=carried, proposal=carried_prop)
            if occ_on:
                carried_prop = (fn.proposal, fn.prop_optimizer)
            stages[key] = fn
        return stages[key]

    logger = MetricsLogger(args.basedir, args.dataname, args.expname) if writer else None
    generator = torch.Generator(device=dev).manual_seed(args.seed + start)

    n_iters = args.n_iters + 1
    print("Begin")
    img_log_idx = 0
    profile_dir = getattr(args, "profile_dir", None) if writer else None

    def _sample_batch(step):
        batch = train_batcher.next(step) if not use_batching else train_batcher.next()
        if depth_batcher is not None:
            batch.update(depth_batcher.next())
            batch.pop("ray_weights")  # loaded-but-unused in the reference loss
        return batch

    prefetcher = None
    if n_inner == 1:
        # batch n+1 is sampled and copied on a worker thread while the
        # device runs step n
        prefetcher = BatchPrefetcher(lambda step: _to_device(shard(_sample_batch(step)), dev),
                                     start, device=dev)

    early_stop = None
    if int(getattr(args, "early_stop_val", 0) or 0) > 0:
        if val_batcher is None:
            print("WARNING: --early_stop_val needs the internal-val ray "
                  "stream (batching path + a non-empty val split); hook "
                  "disabled for this run")
        else:
            early_stop = ValEarlyStop(args.early_stop_val, args.early_stop_min_delta)
            print(f"early-stop hook armed: patience "
                  f"{args.early_stop_val} val evals (i_print cadence), "
                  f"min delta {args.early_stop_min_delta} dB")

    def save(step):
        # whole tensors from a tensor-parallel net's shards (every rank
        # takes part), written by rank 0
        state = {"coarse": full_state_dict(model)}
        if model_fine is not None:
            state["fine"] = full_state_dict(model_fine)
        opt_state = full_optimizer_state(optimizer, *nets)
        if writer:
            path = ckpt.save_checkpoint(rundir, step, state, opt_state, args.index_ensembles)
            print("Saved checkpoints at", path)

    check_step = None
    if debug_nans or debug_infs:
        def check_step(step, metrics):
            _check_finite(step, metrics["loss"], params, debug_nans, debug_infs)

    profiler = None  # open between --profile_start and its end
    prof_state = 0  # 0 = pending, 1 = tracing, 2 = done
    occ_installed = False  # the proposal distilled for the current occ stage?

    def stop_profiler():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"profiler trace written to {profile_dir}")

    try:
        i = start
        while i < n_iters - 1:
            if profile_dir:
                if prof_state == 0 and i >= start + args.profile_start:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    # every thread's spans, the prefetcher's worker's too
                    # (utils/trace.py)
                    profiler = torch.profiler.profile(
                        activities=activities,
                        experimental_config=torch.profiler._ExperimentalConfig(
                            profile_all_threads=True))
                    profiler.start()
                    prof_state = 1
                elif prof_state == 1 and i >= start + args.profile_start + args.profile_steps:
                    stop_profiler()
                    profiler, prof_state = None, 2

            t0 = time.time()
            i_prev = i
            # the dispatch trains steps i+1 .. i+n_inner, so the stage is
            # picked by the first of them (with n_inner > 1 a boundary inside
            # the block rounds up to the next block)
            k_cur = k_for_step(k_stages, i + 1) if k_stages is not None else args.K_samples
            occ_on = (occ_cfg is not None and (i + 1) >= occ_from
                      and (occ_until <= 0 or (i + 1) < occ_until))
            step_fn = stage(k_cur, occ_on)
            if not occ_on and occ_installed:
                occ_installed = False
                print(f"occ stage ended at step {i + 1}: dense "
                      f"N={args.N_samples} cooldown")
            if occ_on and not occ_installed:
                # the occ boundary (or a resume into the stage): distill the
                # proposal from the current field; like the optimizer state,
                # it is not checkpointed and is rebuilt on resume
                from cfnerf_torch.ops.occupancy import distill_proposal, make_density_fn

                t_d = time.time()
                prop, dloss = distill_proposal(
                    make_density_fn(model, render_config),
                    torch.tensor(occ_cfg.lo, device=dev), torch.tensor(occ_cfg.hi, device=dev),
                    generator, width=occ_cfg.prop_width, depth=occ_cfg.prop_depth,
                    multires=occ_cfg.prop_multires, n_points=1 << 18, epochs=2,
                )
                step_fn.install_proposal(prop)
                occ_installed = True
                print(f"occ stage: proposal distilled in "
                      f"{time.time() - t_d:.1f}s (log1p MSE {dloss:.4f}); "
                      f"training at N={occ_n} placed samples")

            if n_inner == 1:
                i, batch = prefetcher.next()
                if occ_on and occ_anneal > 0:
                    batch = dict(batch)
                    batch["occ_floor"] = np.float32(occ_floor_for_step(
                        i, occ_from, occ_anneal, occ_floor_start, args.occ_floor))
                metrics = step_fn(batch, generator)
                if check_step is not None:
                    check_step(i, metrics)
            else:
                samples = [_sample_batch(i + 1 + j) for j in range(n_inner)]
                stacked = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                if occ_on and occ_anneal > 0:
                    stacked["occ_floor"] = np.asarray(
                        [occ_floor_for_step(i + 1 + j, occ_from, occ_anneal,
                                            occ_floor_start, args.occ_floor)
                         for j in range(n_inner)], np.float32)
                if mesh is not None:
                    stacked = shard_stacked_batch(mesh, stacked)
                i += n_inner
                after = None if check_step is None else (
                    lambda j, m: check_step(i_prev + 1 + j, m))  # each inner step
                metrics = step_fn(_to_device(stacked, dev), generator, after_step=after)
            if n_inner > 1:
                metrics = {k: v[-1] for k, v in metrics.items()}  # last inner step

            if _crossed(i_prev, i, args.i_weights):
                save(i)

            if _crossed(i_prev, i, args.i_print):
                metrics = {k: float(v) for k, v in metrics.items()}  # the host read
                scalars = {
                    "train/loss": metrics["loss"],
                    "train/loss_nll": metrics["loss_nll"],
                    "train/logprob": metrics["loss_nll"],
                    "train/loss_entropy": metrics["loss_entropy"],
                    "train/mse": metrics["mse"],
                    "train/psnr": metrics["psnr"],
                    "train/pnsr": metrics["psnr"],  # reference dashboard alias
                    "iter_time": time.time() - t0,
                }
                if "depth_loss" in metrics:
                    scalars["train/depth_loss"] = metrics["depth_loss"]
                if "prop_loss" in metrics:
                    scalars["train/prop_loss"] = metrics["prop_loss"]
                if val_batcher is not None:
                    v_mse, v_psnr, v_nll = val_metrics(val_batcher.next())
                    scalars["val/mse"] = v_mse
                    scalars["val/psnr"] = v_psnr
                    scalars["val/nll"] = v_nll
                if writer:
                    logger.scalars(i, scalars)
                    logger.console(i, scalars, args.colmap_depth)

                if early_stop is not None and early_stop.update(scalars["val/psnr"]):
                    print(f"early stop at step {i}: val/psnr stale for "
                          f"{early_stop.patience} evals (best "
                          f"{early_stop.best:.2f} dB)")
                    save(i)
                    break

            if i > start + 1 and _crossed(i_prev, i, args.i_img):
                for prefix, idx_list in (("train/", scene["i_train"]), ("val/", scene["i_val"])):
                    if len(idx_list) == 0:  # e.g. --llffhold 0 leaves i_val empty
                        continue
                    view = idx_list[img_log_idx % len(idx_list)]
                    out = render_image(
                        render_rays_test, scene["poses"][view], H=H, W=W, focal=focal,
                        ndc=tc.ndc, use_viewdirs=args.use_viewdirs, near=scene["near"],
                        far=scene["far"], tile=args.chunk, device=dev, mesh=mesh,
                    )
                    if writer:
                        logger.image_panel(
                            i, prefix, gt=scene["images"][view],
                            rgb_k=out["rgb_map"].cpu().numpy(),
                            disp_k=out["disp_map"].cpu().numpy(),
                        )
                img_log_idx += 1

            if i > start and _crossed(i_prev, i, args.i_testset) and len(scene["i_val"]) > 0:
                testsavedir = os.path.join(rundir, f"testset_{i:06d}")
                if writer:
                    os.makedirs(testsavedir, exist_ok=True)
                render_path(scene["poses"][scene["i_val"]], scene, args, render_rays_test,
                            savedir=testsavedir if writer else None,
                            render_factor=args.render_factor, device=dev, mesh=mesh)
                print("Saved test set renders to", testsavedir)

            if i > 0 and _crossed(i_prev, i, args.i_video):
                rgbs, disps, _ = render_path(scene["render_poses"], scene, args,
                                             render_rays_test, device=dev, mesh=mesh)
                moviebase = os.path.join(rundir, f"{args.expname}_spiral_{i:06d}_")
                if writer:
                    _save_video(rgbs, moviebase + "rgb.mp4")
                    _save_video(disps / (np.max(disps) + 1e-8), moviebase + "disp.mp4")
    finally:
        # the worker thread must stop even when a step or a render raises
        if prefetcher is not None:
            prefetcher.close()
        if profiler is not None:
            # training ended (or raised) inside the profile window: close
            # the trace so it is written
            stop_profiler()
        if logger is not None:
            logger.close()
    print("Training complete.")
