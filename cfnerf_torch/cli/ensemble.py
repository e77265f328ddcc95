"""Ensemble training and evaluation; counterpart of cfnerf_tpu/cli/ensemble.py.

The reference has ensembles only as checkpoint-name indices
(--index_ensembles / --index_step, run_nerf_uncertainty_NF.py:713-716,
:1086) and leaves the member loop to launch scripts.  Here:

  train:  python -m cfnerf_torch.cli.ensemble train --n_members 3 <flags...>
          trains members 1..N one after another (member m: seed
          args.seed + 1000*m, checkpoint index m); with --parallel all
          members advance together, each dispatch one call of the ensemble
          step (parallel/ensemble.py: for NeRFFlows of any flow family,
          fused or unfused, and for the baselines (--model nerf |
          nerf_dropout | nerf_wild), placed or not, with or without remat,
          the member-batched step, JAX's vmapped one, its trunk and
          render-core or flow-stack kernels launched once for all
          members, the baselines' nets member by member; hierarchical
          sampling's members in turn), on the same per-member streams
  eval:   python -m cfnerf_torch.cli.ensemble eval --n_members 3 <flags...>
          renders each member's K draws of every held-out view and scores
          the MIXTURE: the mean and std over the M*K draws, PSNR, SSIM, the
          KDE NLL and AUSE; --members 1,3 a subset, --members auto the
          members that pass a gate on the run's own logged scalars

Runs on the CUDA device; main(argv, device="cpu") and the functions'
device="cpu" run the same paths on the CPU.  --mesh_devices N (0: every
visible card) runs on N ranks: --parallel over the (ensemble, data) mesh of
parallel/ensemble.py (gcd(M, N) ranks on the member axis, each rank its
block of members and its rows of their rays), eval over the data mesh, the
serial trainer each member's run over the (data, model) mesh.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from cfnerf_torch.parallel.mesh import launch, rank_device
from cfnerf_torch.utils.config import config_parser
from cfnerf_torch.utils.device import DeviceLike, resolve_device


def _member_args(args, member: int):
    a = copy.deepcopy(args)
    a.index_ensembles = member
    a.seed = args.seed + 1000 * member
    return a


def train_ensemble(args, n_members: int, device: DeviceLike = None) -> None:
    from cfnerf_torch.train.loop import train

    for m in range(1, n_members + 1):
        print(f"=== training ensemble member {m}/{n_members} ===")
        train(_member_args(args, m), device=device)


def train_ensemble_parallel(args, n_members: int, device: DeviceLike = None) -> None:
    """All M members advance in lockstep, each dispatch one call of the
    ensemble step (parallel/ensemble.py: the member-batched step where it
    takes the configuration, else the members' steps in turn; it says
    which).  Member m keeps the serial
    workflow's semantics: seed args.seed + 1000*m, its own ray stream and
    generator, checkpoints as ensemble index m in the shared run dir, so
    eval_ensemble reads either.  With --n_inner 1 on the batching path,
    member m takes exactly the trajectory of its serial run.

    Covers the batching and single-image paths, COLMAP depth, --k_schedule
    stages and the occ stage (each member's proposal distilled at the
    boundary from its own field, drawing from its training generator as
    its serial run does, so that with --n_inner 1 the stage's trajectory is
    the serial one too; JAX's parallel CLI seeds a key of its own there,
    which torch cannot reproduce anyway).  --N_importance and --render_only
    raise, as in JAX; the render cadences (i_img / i_video / i_testset) are
    left to the serial path, eval_ensemble renders.

    With --mesh_devices > 1 the run is launched on that many ranks over
    create_ensemble_mesh(M, N): a rank trains its block of members on its
    rows of their batches, a member's gradient reduced over its data ranks;
    data rank 0 of each ensemble group writes its members' checkpoints and
    global rank 0 the log, every member's scalars gathered to it."""
    from cfnerf_torch.data.prefetch import BatchPrefetcher
    from cfnerf_torch.data.sampler import (
        N_DEPTH,
        DepthRayBatcher,
        RayBatcher,
        SingleImageSampler,
        precompute_depth_rays,
        precompute_rays,
    )
    from cfnerf_torch.models.factory import create_nerf, loss_mode_for_model
    from cfnerf_torch.ops.metrics import img2mse, mse2psnr
    from cfnerf_torch.parallel.ensemble import (
        create_ensemble_mesh,
        make_ensemble_train_loop,
        make_ensemble_train_step,
        member_generators,
        shard_members,
    )
    from cfnerf_torch.parallel.mesh import gcd_split, is_writer, mean_over, replicate, shard_batch
    from cfnerf_torch.render.renderer import (
        make_render_rays,
        prepare_rays,
        render_members_test,
    )
    from cfnerf_torch.train import checkpoint as ckpt
    from cfnerf_torch.train.logging import MetricsLogger
    from cfnerf_torch.train.loop import (
        _at_k,
        _crossed,
        _snapshot_args,
        _to_device,
        k_for_step,
        load_dataset,
        mesh_devices,
        needs_launch,
        occ_floor_for_step,
        parse_k_schedule,
    )
    from cfnerf_torch.train.loss import kde_nll
    from cfnerf_torch.train.step import (
        OccTrainConfig,
        TrainConfig,
        batched_step_refusal,
        make_optimizer,
    )
    from cfnerf_torch.utils.config import warn_ignored_flags

    if args.N_importance > 0:
        raise ValueError(
            "--parallel ensemble training does not take the hierarchical "
            "coarse+fine path (it LOSES at matched iters on TPU anyway — "
            "PERF.md); train members serially if you need it"
        )
    if args.render_only:
        raise ValueError("--render_only has no parallel-ensemble mode; use "
                         "cli.ensemble eval")
    n_devices = mesh_devices(args, device)
    n_ens, n_data = gcd_split(n_members, n_devices)
    if args.N_rand % n_data != 0:
        raise ValueError(
            f"N_rand={args.N_rand} must be divisible by the mesh data axis "
            f"({n_data}; ensemble axis took {n_ens})"
        )
    if needs_launch(n_devices):
        launch(_train_ensemble_rank, n_devices, args, n_members, device, device=device)
        return
    dev = resolve_device(device)
    warn_ignored_flags(args)

    scene = load_dataset(args)
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    writer = is_writer()
    if writer:
        _snapshot_args(args, rundir)
    mesh = create_ensemble_mesh(n_members, n_devices) if dist.is_initialized() else None
    # this rank's members (1-based), a contiguous block as P('ensemble') lays them
    mine = [int(m) for m in (range(1, n_members + 1) if mesh is None
                             else shard_members(mesh, np.arange(1, n_members + 1)))]
    n_mine = len(mine)
    # the member checkpoints' writer: data rank 0 of each ensemble group
    member_writer = mesh is None or mesh.index("data") == 0

    def shard(batch):
        return batch if mesh is None else shard_batch(mesh, batch)

    def gather_members(values: np.ndarray) -> np.ndarray:
        """(my members, ...) -> (M, ...): every ensemble group's, in order."""
        if mesh is None:
            return values
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, values)
        return np.concatenate(every[::n_data])

    # per-member build + resume (the serial path's seeds and checkpoint indices)
    models, starts = [], []
    for m in mine:
        model, _fine, render_config, start_m = create_nerf(_member_args(args, m), dev)
        if mesh is not None:
            replicate(mesh, model)
        models.append(model)
        starts.append(start_m)
    if mesh is not None:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, starts)
        starts = [s for ranks_starts in every[::n_data] for s in ranks_starts]
    if len(set(starts)) > 1:
        raise ValueError(
            f"ensemble members resume at different steps {starts}; finish "
            "the stragglers serially (cli.ensemble train) or clear the run "
            "dir — the parallel trainer advances all members in lockstep"
        )
    start = starts[0]
    n_params = sum(p.numel() for p in models[0].parameters())
    where = dev if mesh is None else f"mesh {dict(mesh.shape)}"
    print(f"ensemble-parallel: {n_members} members x {n_params:,} params on {where} "
          f"(resume step {start})")

    # per-member ray streams (each member sees the stream its serial run
    # would: precompute + batcher seeded with the member seed)
    use_batching = not args.no_batching
    member_batchers, member_depth = [], []
    for m in mine:
        seed_m = args.seed + 1000 * m
        if use_batching:
            rays_m = precompute_rays(scene["images"], scene["poses"], focal, scene["i_train"],
                                     seed=seed_m)
            member_batchers.append(RayBatcher(rays_m, args.N_rand, seed=seed_m,
                                              mesh_divisor=n_data))
        else:
            member_batchers.append(SingleImageSampler(
                scene["images"], scene["poses"], focal, scene["i_train"], args.N_rand,
                precrop_iters=args.precrop_iters, precrop_frac=args.precrop_frac,
                seed=seed_m,
            ))
        if args.colmap_depth:
            if not use_batching:
                raise ValueError("--colmap_depth requires the batching path")
            rays_depth = precompute_depth_rays(scene["depth_gts"], scene["poses"], H, W, focal,
                                               scene["i_train"], seed=seed_m)
            member_depth.append(DepthRayBatcher(rays_depth, N_DEPTH, seed=seed_m))

    tc = TrainConfig(
        H=H, W=W, focal=focal,
        ndc=(args.dataset_type == "llff" and not args.no_ndc),
        near=scene["near"], far=scene["far"],
        k_samples=args.K_samples,
        lrate=args.lrate, lrate_decay=args.lrate_decay, start_step=start,
        beta1=args.beta1,
        colmap_depth=args.colmap_depth, depth_lambda=args.depth_lambda,
        loss_mode=loss_mode_for_model(getattr(args, "model", None)),
    )

    # the held-out internal-val stream: every member renders the SAME val
    # batch in test mode, a paired comparison that feeds the --gate_metric
    # val_psnr / val_nll gates; it draws nothing from the training
    # generators, so the members' trajectories do not depend on it.  Members
    # the batched step takes render it together, as JAX's vmapped val_fn
    # does (one render-core, or flow-stack a chain, and trunk launch for
    # all; the other families' flows once on the joined rays; the
    # baselines' nets member by member); the others each through its own
    # render
    val_batcher, render_val = None, []
    val_batched = batched_step_refusal(models, render_config, tc) is None
    if use_batching and args.i_print > 0 and len(scene["i_val_internal"]) > 0:
        rays_rgb_val = precompute_rays(scene["images"], scene["poses"], focal,
                                       scene["i_val_internal"], seed=args.seed + 1)
        if rays_rgb_val.shape[0] >= args.N_rand:
            val_batcher = RayBatcher(rays_rgb_val, args.N_rand, seed=args.seed + 1,
                                     mesh_divisor=n_data)
            render_val = [make_render_rays(m, render_config) for m in models]

    def val_renders(ro, rd, vd, near_v, far_v):
        """Each member's test-mode rgb_map of the val rays."""
        if not val_batched:
            return [rr(ro, rd, vd, near_v, far_v, None, is_test=True)["rgb_map"]
                    for rr in render_val]
        return [out["rgb_map"] for out in render_members_test(
            models, render_config, ro, rd, vd, near_v, far_v)]

    def val_fn(batch):
        """Each member's test-mode mse, psnr and KDE NLL of one val batch
        (under a mesh each rank scores its rows; the means over the data
        axis, every member's gathered)."""
        with torch.inference_mode():
            b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for k, v in shard(batch).items()}
            ro, rd, vd, near_v, far_v = prepare_rays(
                b["rays_o"], b["rays_d"], H=H, W=W, focal=focal, ndc=tc.ndc,
                use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"])
            out = []
            for rgb in val_renders(ro, rd, vd, near_v, far_v):
                mse = img2mse(rgb.mean(-1), b["target"])
                nll = kde_nll(rgb, b["target"], args.K_samples)
                if mesh is not None:
                    mse, nll = mean_over([mse, nll], mesh)
                out.append((float(mse), float(mse2psnr(mse)), float(nll)))
            return [gather_members(np.asarray(v)) for v in zip(*out)]

    # --- stage machinery (K schedule / occ), ensemble-step flavoured ---
    occ_n = int(getattr(args, "occ_train", 0) or 0)
    occ_from = int(getattr(args, "occ_train_from", 0) or 0)
    occ_until = int(getattr(args, "occ_train_until", 0) or 0)
    occ_anneal = int(getattr(args, "occ_floor_anneal", 0) or 0)
    occ_floor_start = float(getattr(args, "occ_floor_start", 1.0))
    occ_cfg = None
    if occ_n > 0:
        from cfnerf_torch.ops.occupancy import aabb_from_scene

        occ_lo, occ_hi = (t.cpu().numpy() for t in aabb_from_scene(scene, args, dev))
        occ_cfg = OccTrainConfig(
            lo=tuple(float(x) for x in occ_lo), hi=tuple(float(x) for x in occ_hi),
            n_candidates=args.occ_candidates, floor=args.occ_floor,
        )
        if occ_until > 0 and occ_until <= occ_from:
            raise ValueError(f"--occ_train_until {occ_until} must be > "
                             f"--occ_train_from {occ_from}")
        print(f"occ training (ensemble-parallel): N={occ_n} placed "
              f"samples/ray from step {occ_from}"
              + (f" until {occ_until}" if occ_until > 0 else ""))

    k_stages = parse_k_schedule(args.k_schedule) if getattr(args, "k_schedule", "") else None
    n_inner = max(1, getattr(args, "n_inner", 1))
    # one Adam and schedule a member for every stage, and once built, one
    # (proposal, its Adam) a member for every occ stage
    carried = [make_optimizer(list(m.parameters()), tc) for m in models]
    optimizers = [c[0] for c in carried]
    carried_props = None
    stages = {}

    def stage(k: int, occ_on: bool):
        nonlocal carried_props
        key = (k, occ_on)
        if key not in stages:
            rc_k, occ_arg = render_config, None
            if occ_on:
                rc_k, occ_arg = dataclasses.replace(render_config, n_samples=occ_n), occ_cfg
            views = [_at_k(m, k) for m in models]
            tc_k = dataclasses.replace(tc, k_samples=k)
            if n_inner > 1:
                fn, _ = make_ensemble_train_loop(views, rc_k, tc_k, n_mine, mesh=mesh,
                                                 n_inner=n_inner, occ=occ_arg,
                                                 optimizers=carried, proposals=carried_props)
            else:
                fn, _ = make_ensemble_train_step(views, rc_k, tc_k, n_mine, mesh=mesh,
                                                 occ=occ_arg, optimizers=carried,
                                                 proposals=carried_props)
            if occ_on:
                carried_props = list(zip(fn.proposals, fn.prop_optimizers))
            stages[key] = fn
        return stages[key]

    logger = MetricsLogger(args.basedir, args.dataname, args.expname) if writer else None
    # member m's generator: what its serial run seeds (train/loop.py)
    generators = member_generators([args.seed + 1000 * m + start for m in mine], dev)

    def member_batch(j, step):
        b = (member_batchers[j].next(step) if not use_batching
             else member_batchers[j].next())
        if member_depth:
            b.update(member_depth[j].next())
            b.pop("ray_weights")  # loaded-but-unused in the reference loss
        return shard(b)

    def stacked_batch(step):
        bs = [member_batch(j, step) for j in range(n_mine)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

    def floors(step):
        f = occ_floor_for_step(step, occ_from, occ_anneal, occ_floor_start, args.occ_floor)
        return np.full((n_mine,), f, np.float32)

    prefetcher = None
    if n_inner == 1:
        # the members' batch n+1 is sampled and copied on a worker thread
        # while the device runs step n
        prefetcher = BatchPrefetcher(lambda step: _to_device(stacked_batch(step), dev), start,
                                     device=dev)

    occ_installed = False
    n_iters = args.n_iters + 1
    try:
        i = start
        while i < n_iters - 1:
            t0 = time.time()
            i_prev = i
            k_cur = k_for_step(k_stages, i + 1) if k_stages else args.K_samples
            occ_on = (occ_cfg is not None and (i + 1) >= occ_from
                      and (occ_until <= 0 or (i + 1) < occ_until))
            step_fn = stage(k_cur, occ_on)
            if not occ_on and occ_installed:
                occ_installed = False
                print(f"occ stage ended at step {i + 1}: dense cooldown")
            if occ_on and not occ_installed:
                # each member's proposal distilled from ITS OWN current
                # field, drawing from its training generator as its serial
                # run does (train/loop.py)
                from cfnerf_torch.ops.occupancy import distill_proposal, make_density_fn

                t_d = time.time()
                lo = torch.tensor(occ_cfg.lo, device=dev)
                hi = torch.tensor(occ_cfg.hi, device=dev)
                props = []
                for model, gen in zip(models, generators):
                    prop, _ = distill_proposal(
                        make_density_fn(model, render_config), lo, hi, gen,
                        width=occ_cfg.prop_width, depth=occ_cfg.prop_depth,
                        multires=occ_cfg.prop_multires, n_points=1 << 18, epochs=2,
                    )
                    props.append(prop)
                step_fn.install_proposals(props)
                occ_installed = True
                print(f"occ stage: {n_members} proposals distilled in "
                      f"{time.time() - t_d:.1f}s; training at N={occ_n}")

            if n_inner == 1:
                i, batch = prefetcher.next()
                if occ_on and occ_anneal > 0:
                    batch = dict(batch, occ_floor=floors(i))
                metrics = step_fn(batch, generators)
            else:
                samples = [stacked_batch(i + 1 + j) for j in range(n_inner)]
                stacked = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                if occ_on and occ_anneal > 0:
                    stacked["occ_floor"] = np.stack([floors(i + 1 + j) for j in range(n_inner)])
                i += n_inner
                metrics = step_fn(_to_device(stacked, dev), generators)
                metrics = {k: v[-1] for k, v in metrics.items()}  # last inner step

            if _crossed(i_prev, i, args.i_weights) and member_writer:
                for j, (m, model) in enumerate(zip(mine, models)):
                    ckpt.save_checkpoint(rundir, i, {"coarse": model.state_dict()},
                                         optimizers[j].state_dict(), m)
                print(f"Saved {n_members} member checkpoints at step {i}")

            if _crossed(i_prev, i, args.i_print):
                # the host read, every member's
                metrics = {k: gather_members(v.cpu().numpy()) for k, v in metrics.items()}
                scalars = {
                    "train/loss": float(np.mean(metrics["loss"])),
                    "train/psnr": float(np.mean(metrics["psnr"])),
                    "iter_time": time.time() - t0,
                }
                for m in range(n_members):
                    scalars[f"train/psnr_m{m + 1:02d}"] = float(metrics["psnr"][m])
                if val_batcher is not None:
                    v_mse, v_psnr, v_nll = val_fn(val_batcher.next())
                    scalars["val/mse"] = float(np.mean(v_mse))
                    scalars["val/psnr"] = float(np.mean(v_psnr))
                    for m in range(n_members):
                        scalars[f"val/psnr_m{m + 1:02d}"] = float(v_psnr[m])
                        scalars[f"val/nll_m{m + 1:02d}"] = float(v_nll[m])
                if writer:
                    logger.scalars(i, scalars)
                print(f"[ensemble-parallel] step {i}: loss={scalars['train/loss']:.4f} "
                      f"psnr/member=" + "/".join(f"{float(p):.2f}" for p in metrics["psnr"]))
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if logger is not None:
            logger.close()
    print("Ensemble-parallel training complete.")


def _train_ensemble_rank(rank: int, args, n_members: int, device: DeviceLike) -> None:
    train_ensemble_parallel(args, n_members, device=rank_device(device, rank))


def member_metric_medians(metrics_path: str, n_members: int,
                          metric: str = "train/psnr",
                          window: int = 10) -> dict:
    """Per-member medians of a logged scalar from a run's metrics.jsonl.

    Parallel-trained runs (train_ensemble_parallel) log a tagged
    `<metric>_mXX` scalar per member: read those directly.  Serial runs
    (train_ensemble) append each member's records to the same file with no
    member tag; their steps ascend per member and reset when the next member
    starts, so the records are cut at each step reset and given to members
    1..M in launch order.  Returns {member: median of the last `window`
    values}.

    `metric` is the logged scalar: "train/psnr" (always there), or the
    held-out stream's "val/psnr" / "val/nll" (logged at i_print when the run
    had an internal-val split)."""
    recs = []
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))

    tagged = {}
    for m in range(1, n_members + 1):
        key = f"{metric}_m{m:02d}"
        vals = [r[key] for r in recs if key in r]
        if vals:
            tagged[m] = float(np.median(vals[-window:]))
    if len(tagged) == n_members:
        return tagged
    if tagged:
        raise ValueError(
            f"{metrics_path}: found tagged {metric} for members "
            f"{sorted(tagged)} but n_members={n_members} — partial "
            "parallel-training log; pass an explicit --members subset"
        )

    # serial fallback: segment untagged records on step resets
    seq = [(r["step"], r[metric]) for r in recs
           if metric in r and "step" in r]
    if not seq:
        raise ValueError(
            f"{metrics_path}: no {metric} records"
            + (" — val scalars require an internal-val split (logged at "
               "i_print cadence); gate on train_psnr instead"
               if metric.startswith("val/") else ""))
    segments, cur = [], [seq[0]]
    for prev, nxt in zip(seq, seq[1:]):
        if nxt[0] <= prev[0]:
            segments.append(cur)
            cur = []
        cur.append(nxt)
    segments.append(cur)
    if len(segments) != n_members:
        raise ValueError(
            f"{metrics_path}: records segment into {len(segments)} serial "
            f"training runs but n_members={n_members} — resumed or mixed "
            "logs can't be attributed; pass an explicit --members subset"
        )
    return {m: float(np.median([p for _, p in seg][-window:]))
            for m, seg in enumerate(segments, 1)}


def member_train_psnrs(metrics_path: str, n_members: int, window: int = 10) -> dict:
    """Per-member train-side PSNR medians."""
    return member_metric_medians(metrics_path, n_members, "train/psnr", window=window)


# gate metric registry: logged scalar name, whether HIGHER is better, the
# unit, which picks the threshold argument (dB for the PSNR gates, nat for
# the NLL gate)
GATE_METRICS = {
    "train_psnr": ("train/psnr", True, "dB"),
    "val_psnr": ("val/psnr", True, "dB"),
    "val_nll": ("val/nll", False, "nat"),
}


def auto_member_subset(args, n_members: int,
                       threshold_db: float = 2.0,
                       gate_metric: str = "train_psnr",
                       threshold_nat: float = 1.0) -> List[int]:
    """The members whose per-member median of the gate metric lies within
    the threshold of the member median on the right side; the rest are
    dropped from the mixture (a bad member shows in the run's own logged
    scalars, no human in the loop).

    --gate_metric: train_psnr (default; a weak seed trains several dB below
    its peers throughout), val_psnr (the same on the held-out stream, robust
    to train-side overfit), val_nll (held-out calibration, which the PSNR
    gates cannot see; threshold --members_auto_nat ABOVE the median)."""
    if gate_metric not in GATE_METRICS:
        raise ValueError(f"--gate_metric {gate_metric!r} not in "
                         f"{sorted(GATE_METRICS)}")
    metric, higher_better, unit = GATE_METRICS[gate_metric]
    threshold = threshold_db if unit == "dB" else threshold_nat
    metrics_path = os.path.join(args.basedir, args.dataname, "summaries", args.expname,
                                "metrics.jsonl")
    meds = member_metric_medians(metrics_path, n_members, metric)
    med = float(np.median(list(meds.values())))
    if higher_better:
        keep = [m for m in sorted(meds) if meds[m] >= med - threshold]
    else:
        keep = [m for m in sorted(meds) if meds[m] <= med + threshold]
    dropped = [m for m in sorted(meds) if m not in keep]
    report = ", ".join(f"m{m:02d}={meds[m]:.2f} {unit}"
                       + (" [DROPPED]" if m in dropped else "")
                       for m in sorted(meds))
    sign = "-" if higher_better else "+"
    print(f"--members auto: {metric} medians {report} "
          f"(member median {med:.2f}, threshold {sign}{threshold:.1f} {unit})")
    if not keep:
        # cannot happen against the members' own median; gate nothing
        print("--members auto: no member survives the gate; keeping all")
        return list(range(1, n_members + 1))
    if dropped:
        print(f"--members auto: dropping {dropped} from the mixture "
              "(EVAL_r13: subset mixtures beat every member once the bad "
              "seed is gone)")
    return keep


def eval_ensemble(args, n_members: int, members=None, device: DeviceLike = None) -> dict:
    """Mixture eval over ensemble members (M*K draws, equal weight).

    `members` (1-based, default all of 1..n_members) picks a SUBSET mixture,
    the lever for a bad seed.  Each member's view is rendered by
    render_image through its own checkpoint; a member without one raises
    FileNotFoundError.  Writes <run dir>/eval_ensembleN_<step>/ (all
    members) or eval_ensemble_m1-3_<step>/ (a subset): NNN_pred.png,
    NNN_std.png, metrics.json.  Returns the summary: n_members, members,
    the mean PSNR / SSIM / NLL / AUSE over the views, and each view's."""
    from cfnerf_torch.cli.eval import kde_nll_per_pixel
    from cfnerf_torch.data.image_io import imwrite_png, resize_area
    from cfnerf_torch.models.factory import create_nerf
    from cfnerf_torch.ops.metrics import sparsification_plot, ssim, std_over_k, to8b
    from cfnerf_torch.render.renderer import make_render_rays, render_image
    from cfnerf_torch.parallel.mesh import create_mesh, is_writer
    from cfnerf_torch.train import checkpoint as ckpt
    from cfnerf_torch.train.loop import load_dataset, mesh_devices, needs_launch

    if members is None:
        members = list(range(1, n_members + 1))
    members = sorted(set(int(m) for m in members))
    if not members or any(m < 1 or m > n_members for m in members):
        raise ValueError(
            f"--members must pick from 1..{n_members}, got {members}"
        )
    n_devices = mesh_devices(args, device)
    if needs_launch(n_devices):
        return launch(_eval_ensemble_rank, n_devices, args, n_members, members, device,
                      device=device)[0]
    dev = resolve_device(device)
    # every member's views render over the data mesh (JAX :576-577)
    mesh = create_mesh(n_devices) if dist.is_initialized() else None
    writer = is_writer()

    scene = load_dataset(args)
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    rf = args.render_factor
    He, We, fe = (H, W, focal) if rf == 0 else (H // rf, W // rf, focal / rf)

    # per-member renders
    member_renders: List[dict] = []
    member_steps: List[int] = []
    start = 0
    for m in members:
        margs = _member_args(args, m)
        model, model_fine, render_config, start = create_nerf(margs, dev)
        if start == 0:
            # a member without a checkpoint would mix FRESH RANDOM params
            # into the ensemble and silently poison every aggregate metric
            raise FileNotFoundError(
                f"ensemble member {m:02d}: no checkpoint found under the "
                f"run dir for expname={margs.expname!r} — train all "
                f"members first (cli.ensemble train)"
            )
        rr = make_render_rays(model, render_config, model_fine)
        renders = {}
        for view in scene["i_val"]:
            out = render_image(
                rr, scene["poses"][view], H=He, W=We, focal=fe,
                ndc=(args.dataset_type == "llff" and not args.no_ndc),
                use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"],
                tile=args.chunk, device=dev, mesh=mesh,
            )
            renders[view] = out["rgb_map"].cpu().numpy()  # (H, W, 3, K)
        member_renders.append(renders)
        member_steps.append(start)
        print(f"member {m}: rendered {len(renders)} views @ step {start}")

    if len(set(member_steps)) > 1:
        print(f"WARNING: ensemble members restored at different steps "
              f"{member_steps}; the output dir is tagged with the last one")

    # aggregate: mixture over members -> (H, W, 3, M*K)
    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    tag = (f"eval_ensemble{n_members}" if len(members) == n_members
           else "eval_ensemble_m" + "-".join(str(m) for m in members))
    outdir = os.path.join(rundir, f"{tag}_{start:06d}")
    if writer:
        os.makedirs(outdir, exist_ok=True)

    per_view = []
    for view in scene["i_val"]:
        rgb_k = np.concatenate([mr[view] for mr in member_renders], axis=-1)
        MK = rgb_k.shape[-1]
        gt = scene["images"][view]
        if rf != 0:
            gt = resize_area(gt, We, He)
        rgb_mean = rgb_k.mean(-1)
        rgb_std = std_over_k(torch.from_numpy(rgb_k)).numpy()
        mse = float(((rgb_mean - gt) ** 2).mean())
        psnr = -10.0 * np.log10(mse)
        ssim_v = float(ssim(torch.from_numpy(rgb_mean).to(dev), torch.from_numpy(gt).to(dev)))
        nll = float(kde_nll_per_pixel(rgb_k, gt, MK).mean())
        err = ((rgb_mean - gt) ** 2).mean(-1).reshape(-1)
        var = (rgb_std ** 2).mean(-1).reshape(-1)
        oracle, by_var = sparsification_plot(var, err)
        ause = float(np.mean(by_var - oracle))
        per_view.append(dict(view=int(view), psnr=psnr, ssim=ssim_v, nll=nll, ause=ause))
        if not writer:
            continue
        imwrite_png(os.path.join(outdir, f"{view:03d}_pred.png"), to8b(rgb_mean))
        imwrite_png(os.path.join(outdir, f"{view:03d}_std.png"),
                    to8b(rgb_std / (rgb_std.max() + 1e-8)))

    summary = {
        "n_members": len(members),
        "members": members,
        "psnr": float(np.mean([v["psnr"] for v in per_view])),
        "ssim": float(np.mean([v["ssim"] for v in per_view])),
        "nll": float(np.mean([v["nll"] for v in per_view])),
        "ause": float(np.mean([v["ause"] for v in per_view])),
        "views": per_view,
    }
    if writer:
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "views"}))
    return summary


def _eval_ensemble_rank(rank: int, args, n_members: int, members, device: DeviceLike) -> dict:
    return eval_ensemble(args, n_members, members=members, device=rank_device(device, rank))


def parser():
    """The training flags (utils/config.py) and the ensemble's own."""
    p = config_parser()
    p.add_argument("--n_members", type=int, default=3)
    p.add_argument(
        "--parallel", action="store_true",
        help="train all members together, each step one call of every "
             "member's step (parallel/ensemble.py), instead of one member "
             "after another",
    )
    p.add_argument(
        "--members", type=str, default="",
        help="eval only: comma-separated 1-based member subset for the "
             "mixture (e.g. 1,3), to drop a laggard member identified from "
             "its train-side PSNR; 'auto' gates outlier members from the "
             "run's own metrics.jsonl (auto_member_subset); default all "
             "members",
    )
    p.add_argument(
        "--members_auto_db", type=float, default=2.0,
        help="--members auto gate: drop members whose PSNR-gate median "
             "is more than this many dB below the member median",
    )
    p.add_argument(
        "--gate_metric", type=str, default="train_psnr", choices=sorted(GATE_METRICS),
        help="--members auto gate signal: train_psnr, or the held-out "
             "internal-val stream val_psnr / val_nll (robust to train-side "
             "overfit; val_nll catches calibration outliers the PSNR gates "
             "cannot see)",
    )
    p.add_argument(
        "--members_auto_nat", type=float, default=1.0,
        help="--gate_metric val_nll threshold: drop members whose val NLL "
             "median is more than this many nat ABOVE the member median",
    )
    return p


def main(argv=None, device: DeviceLike = None):
    """`train` or `eval` (then the flags); eval returns the summary.  Without
    a subcommand: the usage, exit code 2."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "eval"):
        print("usage: python -m cfnerf_torch.cli.ensemble {train|eval} "
              "--n_members N <training flags...>")
        sys.exit(2)
    mode = argv.pop(0)
    args = parser().parse_args(argv)
    if mode == "train":
        if args.parallel:
            train_ensemble_parallel(args, args.n_members, device=device)
        else:
            train_ensemble(args, args.n_members, device=device)
    else:
        if args.members.strip().lower() == "auto":
            subset = auto_member_subset(
                args, args.n_members, threshold_db=args.members_auto_db,
                gate_metric=args.gate_metric, threshold_nat=args.members_auto_nat,
            )
        else:
            subset = ([int(s) for s in args.members.split(",") if s.strip()]
                      if args.members else None)
        return eval_ensemble(args, args.n_members, members=subset, device=device)


if __name__ == "__main__":
    main()
