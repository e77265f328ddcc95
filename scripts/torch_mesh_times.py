#!/usr/bin/env python3
"""Times the port's several-device paths over NCCL on four cards of one
host, each beside the same work on one card (no process group).

    python3 scripts/torch_mesh_times.py [--ranks 4] [--steps 10] [--out FILE]

Needs --ranks CUDA devices.  Parts (chip_smoke.py's helpers: the flagship
model, D8/W512 N128 K32 F4, random weights from seed 0; the synthetic
scene's batches):

  * dp        the flagship training step, 512 + 128 rays a rank (weak
              scaling), against one card at 512 + 128 rays; the first
              step's reduced gradients against one card's at the global
              batch (relative max a leaf);
  * serve     the 400x400 flagship view, 8192-ray tiles split over the
              ranks, against one card (max abs difference);
  * tp        the (data ranks / 2, model 2) step at 512 + 128 rays a data
              rank, the trunk's widths split over the model axis;
  * ensemble  4 members on (ensemble 4, data 1) and 2 on (ensemble 2, data
              2), 512 + 128 rays a member step, against the same members'
              step on one card.

Prints one JSON object a part and the cards' names and power limits; with
--out FILE also writes them all to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cfnerf_torch.models.factory import build_model  # noqa: E402
from cfnerf_torch.ops.kernels import _build  # noqa: E402
from cfnerf_torch.parallel import ensemble as pens  # noqa: E402
from cfnerf_torch.parallel import mesh as pmesh  # noqa: E402
from cfnerf_torch.render.renderer import make_render_rays, render_image  # noqa: E402
from cfnerf_torch.train.step import TrainConfig  # noqa: E402

RAYS = cs.N_RAND + cs.N_DEPTH


def serve(mesh):
    """Two renders of the flagship view (the second timed): (rgb_map on the
    CPU, seconds)."""
    model, _, rc = build_model(types.SimpleNamespace(**cs.FLAGSHIP, trunk_impl="xla"))
    if mesh is not None:
        pmesh.replicate(mesh, model)
    rr = make_render_rays(model, rc)
    c2w = cs.pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    kw = dict(H=cs.H, W=cs.W, focal=cs.FOCAL, ndc=False, use_viewdirs=True, near=cs.NEAR,
              far=cs.FAR, tile=cs.TILE, mesh=mesh)
    render_image(rr, c2w, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_image(rr, c2w, **kw)
    torch.cuda.synchronize()
    return out["rgb_map"].cpu(), time.perf_counter() - t0


def ensemble_steps(mesh, n_members, steps):
    """`steps` steps of n_members flagship members (seeds 0..M-1; a batch
    stream a member) over `mesh` (None: one card): the step times after
    the first."""
    members = list(range(n_members)) if mesh is None else [
        int(m) for m in pens.shard_members(mesh, np.arange(n_members))]
    models = []
    for m in members:
        model, _, rc = build_model(types.SimpleNamespace(**dict(cs.FLAGSHIP, seed=m),
                                                         trunk_impl="xla"))
        models.append(model if mesh is None else pmesh.replicate(mesh, model))
    cfg = TrainConfig(H=cs.H, W=cs.W, focal=cs.FOCAL, ndc=False, near=cs.NEAR, far=cs.FAR,
                      k_samples=cs.FLAGSHIP["K_samples"], **cs.TRAIN_CFG)
    step, _ = pens.make_ensemble_train_step(models, rc, cfg, len(members), mesh=mesh)
    n_data = 1 if mesh is None else mesh.shape[pmesh.DATA_AXIS]
    streams = [cs.mesh_batches(cs.N_RAND * n_data, cs.N_DEPTH * n_data) for _ in members]
    gens = [torch.Generator(device="cuda").manual_seed(20 + m) for m in members]
    times = []
    for _ in range(steps):
        batches = [b() for b in streams]
        if mesh is not None:
            batches = [pmesh.shard_batch(mesh, b) for b in batches]
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        t0 = time.perf_counter()
        step(stacked, gens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times[1:]


def _ranks(rank, n, steps):
    """Every part over the n NCCL ranks; rank 0's numbers."""
    out = {}
    dp = cs.mesh_steps(pmesh.create_mesh(n), cs.N_RAND * n, cs.N_DEPTH * n, steps)
    out["dp"] = dict(grads=dp["grads"], times=dp["times"], launches=dp["launches"])
    out["serve"] = serve(pmesh.create_mesh(n))
    tp = cs.mesh_steps(pmesh.create_mesh(n, model_parallel=2), cs.N_RAND * n // 2,
                       cs.N_DEPTH * n // 2, steps)
    out["tp"] = dict(times=tp["times"], launches=tp["launches"])
    for m in (n, n // 2):
        out[f"ensemble_{m}"] = ensemble_steps(pens.create_ensemble_mesh(m, n), m, steps)
    return out if rank == 0 else {"launches": out["dp"]["launches"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    if torch.cuda.device_count() < a.ranks:
        print(f"torch_mesh_times: {a.ranks} CUDA devices needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    n = a.ranks
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    _build.build()
    # one card, no group: the same work at one card's share, and the dp
    # reference at the global batch
    one_dp = cs.mesh_steps(None, cs.N_RAND, cs.N_DEPTH, a.steps)
    ref_grads = cs.mesh_steps(None, cs.N_RAND * n, cs.N_DEPTH * n, 1)["grads"]
    one_rgb, one_serve_s = serve(None)
    one_ens = {m: ensemble_steps(None, m, a.steps) for m in (n, n // 2)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = pmesh.launch(_ranks, n, n, a.steps, timeout=1500)
    call_s = time.perf_counter() - t0
    r0 = ranks[0]
    med = statistics.median
    worst = max(float((r0["dp"]["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for k, g in ref_grads.items())
    rows = [
        {"part": "dp", "ranks": n, "rays_per_rank_step": RAYS,
         "step_ms": 1e3 * med(r0["dp"]["times"]), "step_ms_one_card": 1e3 * med(one_dp["times"]),
         "rays_per_s": n * RAYS / med(r0["dp"]["times"]),
         "rays_per_s_one_card": RAYS / med(one_dp["times"]),
         "first_step_grad_max_rel_vs_one_card_global_batch": worst,
         "launches_per_rank": [r["launches"] if "launches" in r else r["dp"]["launches"]
                               for r in ranks]},
        {"part": "serve", "ranks": n, "view": [cs.H, cs.W], "seconds": r0["serve"][1],
         "seconds_one_card": one_serve_s, "rays_per_s": cs.H * cs.W / r0["serve"][1],
         "rays_per_s_one_card": cs.H * cs.W / one_serve_s,
         "max_abs_diff_vs_one_card": float((r0["serve"][0] - one_rgb).abs().max())},
        {"part": "tp", "mesh": {"data": n // 2, "model": 2}, "rays_per_data_rank_step": RAYS,
         "step_ms": 1e3 * med(r0["tp"]["times"]),
         "rays_per_s": n // 2 * RAYS / med(r0["tp"]["times"])},
    ]
    for m in (n, n // 2):
        e, d = pmesh.gcd_split(m, n)
        rows.append({"part": f"ensemble_{m}", "mesh": {"ensemble": e, "data": d},
                     "members": m, "rays_per_member_step": RAYS * d,
                     "step_ms": 1e3 * med(r0[f"ensemble_{m}"]),
                     "rays_per_s": m * RAYS * d / med(r0[f"ensemble_{m}"]),
                     "step_ms_one_card": 1e3 * med(one_ens[m]),
                     "rays_per_s_one_card": m * RAYS / med(one_ens[m])})
    result = {"cards": smi.strip().splitlines(), "torch": torch.__version__,
              "steps": a.steps, "call_s": call_s, "parts": rows}
    for row in rows:
        print(json.dumps(row), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    print(smi.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
