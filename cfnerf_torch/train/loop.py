"""The training loop's pieces; counterparts of cfnerf_tpu/train/loop.py's
schedule helpers (:54-113, the same errors and messages), its dataset
dispatch `load_dataset` (:145-188) and its run-dir snapshot `_snapshot_args`
(:191-199).  The loop itself (`train`) comes with slice 6b.

  * --k_schedule 'K:step,...': a piecewise-constant K over global steps
    (parse_k_schedule, k_for_step).  K is no parameter axis, so weights and
    optimizer state carry across stages;
  * --occ_floor_anneal: the placement floor of the occ stage, linear from
    --occ_floor_start at the stage boundary to --occ_floor
    (occ_floor_for_step), fed to the step as batch["occ_floor"].
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from cfnerf_torch.data.blender import load_blender_data
from cfnerf_torch.data.llff import load_colmap_depth, load_llff_data
from cfnerf_torch.data.sampler import lf_scene_splits


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
