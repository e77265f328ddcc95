"""Entry point of the flagship forward; counterpart of __graft_entry__.py's
_flagship and entry().

entry() returns (fn, example_args): fn(*example_args) renders a 256-ray
batch through the flagship model (the reference's headline configuration:
D=8, W=512, N=128 samples a ray, K=32 draws, 4 triangular Sylvester flows,
h=64) in test mode (K-sample inference) and returns (rgb_map (R, 3, K),
disp_map (R, K), depth_map (R, K)).  The model is the first example
argument, as the params are JAX's; its weights are init_params' from seed
0.  On the CUDA device unless entry(device="cpu"); the same seed gives the
same weights on both.

dryrun_multichip(n) is JAX's multi-device dry run on the CPU: n gloo ranks
(parallel/mesh.py:launch) take tiny training steps, renders and a short
trajectory over the mesh, in JAX's order, each held against the same work
run on one device without a process group.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cfnerf_torch.models.factory import init_params
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays
from cfnerf_torch.utils.device import DeviceLike, resolve_device

N_RAYS = 256


def _flagship(k_samples=32, n_samples=128, depth=8, width=512):
    """(model, render config) at the flagship widths, or smaller ones; the
    model on the CPU with the module's default init."""
    model = NeRFFlows(
        net_depth=depth, net_width=width, input_ch=63, input_ch_views=27,
        skips=(depth // 2,), h_alpha_size=64, h_rgb_size=64, n_flows=4,
        k_samples=k_samples, use_viewdirs=True, type_flows="triangular",
    )
    rc = RenderConfig(n_samples=n_samples, perturb=True, use_viewdirs=True)
    return model, rc


def example_rays(device: DeviceLike = None):
    """The 256 rays of entry(): from the origin along (0.05, 0.05, -1),
    near 0.5, far 4."""
    dev = resolve_device(device)
    rays_o = torch.zeros((N_RAYS, 3), device=dev)
    rays_d = torch.cat([torch.full((N_RAYS, 2), 0.05, device=dev),
                        torch.full((N_RAYS, 1), -1.0, device=dev)], -1)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = torch.full((N_RAYS, 1), 0.5, device=dev)
    far = torch.full((N_RAYS, 1), 4.0, device=dev)
    return rays_o, rays_d, viewdirs, near, far


def make_fn(rc: RenderConfig):
    """fn(model, rays_o, rays_d, viewdirs, near, far) -> (rgb, disp, depth):
    a test-mode render of the rays through `model`."""

    def fn(model, rays_o, rays_d, viewdirs, near, far):
        with torch.inference_mode():
            out = make_render_rays(model, rc)(rays_o, rays_d, viewdirs, near, far, None,
                                              is_test=True)
        return out["rgb_map"], out["disp_map"], out["depth_map"]

    return fn


def entry(device: DeviceLike = None):
    """Returns (fn, example_args): the flagship model from seed 0 on the
    device and the 256 example rays; fn(*example_args) renders them."""
    dev = resolve_device(device)
    model, rc = _flagship()
    model = init_params(model, seed=0).to(dev)
    return make_fn(rc), (model, *example_rays(dev))


# ---------------------------------------------------------------- dry run

# JAX's tests/test_sharding.py tolerances: one step, and several (its
# six-step trajectory across a K boundary and a checkpoint)
STEP_TOL = dict(loss_rtol=1e-5, rtol=2e-5, atol=2e-6)
TRAJECTORY_TOL = dict(loss_rtol=1e-4, rtol=5e-4, atol=5e-5)
DRYRUN_CHECKS = ("data_parallel_step", "hierarchical_step", "n_inner_loop", "fused_step",
                 "mesh_render", "occ_grid_render", "occ_train_step", "k_schedule_trajectory",
                 "ensemble_step", "tensor_parallel_step")


def _tiny(k=4, seed=0):
    model, rc = _flagship(k_samples=k, n_samples=16, depth=2, width=32)
    return init_params(model, seed=seed), rc


def _rays(rng, n):
    return (rng.randn(n, 3).astype(np.float32),
            np.concatenate([rng.randn(n, 2) * 0.05, -np.ones((n, 1))], -1).astype(np.float32))


def _batch(n_rgb, n_depth, seed):
    rng = np.random.RandomState(seed)
    ro, rd = _rays(rng, n_rgb)
    b = dict(rays_o=ro, rays_d=rd, target=rng.rand(n_rgb, 3).astype(np.float32))
    if n_depth:
        dro, drd = _rays(rng, n_depth)
        b.update(depth_rays_o=dro, depth_rays_d=drd,
                 target_depth=rng.rand(n_depth).astype(np.float32))
    return b


def _state(*nets):
    from cfnerf_torch.parallel.mesh import full_state_dict

    return {f"{i}.{k}": v.detach().numpy().copy()
            for i, net in enumerate(nets) for k, v in full_state_dict(net).items()}


def _compare(mesh_run, one_run, loss_rtol, rtol, atol):
    """'' when (metrics, state) of the mesh run match the one-device run's,
    else what differs."""
    (m_n, s_n), (m_1, s_1) = mesh_run, one_run
    try:
        for k in m_1:
            np.testing.assert_allclose(m_n[k], m_1[k], rtol=loss_rtol, err_msg=k)
        for k in s_1:
            np.testing.assert_allclose(s_n[k], s_1[k], rtol=rtol, atol=atol, err_msg=k)
    except AssertionError as e:
        return str(e)
    return ""


def _dryrun_rank(rank: int, n: int) -> Dict[str, str]:
    """Rank `rank`'s part of dryrun_multichip.  Every rank runs each check
    over the mesh; rank 0 also runs it on one device, compares, prints a
    line and returns {check: '' or what differs} (the other ranks {})."""
    from cfnerf_torch.ops.occupancy import make_occ_render_rays
    from cfnerf_torch.parallel import ensemble as pens
    from cfnerf_torch.parallel.mesh import (
        create_mesh,
        full_state_dict,
        replicate,
        shard_batch,
        shard_params_tp,
        shard_stacked_batch,
    )
    from cfnerf_torch.render.renderer import render_image
    from cfnerf_torch.train import checkpoint as ckpt
    from cfnerf_torch.train.step import (
        OccTrainConfig,
        TrainConfig,
        make_train_loop,
        make_train_step,
    )

    torch.set_num_threads(1)
    lead = rank == 0
    errors: Dict[str, str] = {}
    mesh = create_mesh(n)
    _, rc = _tiny()
    tc = TrainConfig(H=8, W=8, focal=10.0, ndc=False, near=0.5, far=4.0, k_samples=4,
                     beta1=0.01, colmap_depth=True, depth_lambda=0.01)
    tc_rgb = dataclasses.replace(tc, colmap_depth=False)
    batch = _batch(4 * n, 2 * n, 0)  # rays divisible by the data axis
    batch_rgb = {k: v for k, v in batch.items() if not k.startswith(("depth", "target_d"))}

    def metrics_of(m):
        return {k: float(v) for k, v in m.items()}

    def train_once(m_, rc_, cfg, b, seed, *, fine=False, occ=None, n_inner=1):
        """One step (or one n_inner loop) of fresh tiny nets over mesh m_
        (None: one device): (metrics, the nets' whole state)."""
        nets = [_tiny()[0]] + ([_tiny(seed=2)[0]] if fine else [])
        if m_ is not None:
            for net in nets:
                replicate(m_, net)
                shard_params_tp(m_, net)
        gen = torch.Generator().manual_seed(seed)
        fine_net = nets[1] if fine else None
        if n_inner > 1:
            loop, _ = make_train_loop(nets[0], rc_, cfg, mesh=m_, n_inner=n_inner,
                                      model_fine=fine_net)
            stacked = {k: np.stack([v] * n_inner) for k, v in b.items()}
            stacked = stacked if m_ is None else shard_stacked_batch(m_, stacked)
            met = {k: v[-1] for k, v in loop(stacked, gen).items()}
            return metrics_of(met), _state(*nets)
        step, _ = make_train_step(nets[0], rc_, cfg, mesh=m_, model_fine=fine_net, occ=occ)
        met = step(b if m_ is None else shard_batch(m_, b), gen)
        state = _state(*nets)
        if occ is not None:
            state.update({f"prop.{k}": v.detach().numpy().copy()
                          for k, v in step.proposal.state_dict().items()})
        return metrics_of(met), state

    def check(name, run, m_, tol=STEP_TOL):
        got = run(m_)
        if lead:
            errors[name] = _compare(got, run(None), **tol)
            loss = got[0].get("loss", got[0].get("loss_0"))
            said = "matches one device" if not errors[name] else "DIFFERS from one device"
            print(f"dryrun_multichip: {name} over {dict(m_.shape)} {said}"
                  + ("" if loss is None else f", loss={loss:.4f}"), flush=True)

    # the data-parallel step with COLMAP depth rays, then hierarchical,
    # n_inner = 2 and the fused render core (its plain version on the CPU)
    check("data_parallel_step", lambda m_: train_once(m_, rc, tc, batch, 1), mesh)
    check("hierarchical_step",
          lambda m_: train_once(m_, dataclasses.replace(rc, n_importance=8), tc_rgb, batch_rgb,
                                3, fine=True), mesh)
    check("n_inner_loop", lambda m_: train_once(m_, rc, tc, batch, 4, n_inner=2), mesh,
          TRAJECTORY_TOL)  # two steps: a trajectory
    check("fused_step",
          lambda m_: train_once(m_, dataclasses.replace(rc, fused="interpret"), tc_rgb,
                                _batch(128, 0, 5), 5), mesh)

    # the mesh render, then grid-placed serving (the grid replicated)
    img_kw = dict(H=8, W=8, focal=10.0, ndc=False, use_viewdirs=True, near=0.5, far=4.0,
                  tile=30, device="cpu")
    grid = torch.from_numpy(np.exp(np.random.RandomState(7).randn(16, 16, 16)).astype(np.float32))
    lo, hi = torch.full((3,), -4.0), torch.full((3,), 4.0)

    def render(m_, occ_grid=False):
        model = _tiny()[0]
        if m_ is not None:
            replicate(m_, model)
        rr = make_render_rays(model, rc)
        if occ_grid:
            rr = make_occ_render_rays(rr, grid, lo, hi, rc.n_samples, n_candidates=32)
        out = render_image(rr, torch.eye(4)[:3], mesh=m_, **img_kw)
        return {}, {k: v.numpy() for k, v in out.items()}

    render_tol = dict(loss_rtol=1e-5, rtol=1e-5, atol=1e-6)
    check("mesh_render", render, mesh, render_tol)
    check("occ_grid_render", lambda m_: render(m_, occ_grid=True), mesh, render_tol)

    # proposal-placed training: the floor rides in the batch as a scalar
    occ_cfg = OccTrainConfig(lo=(-4.0,) * 3, hi=(4.0,) * 3, n_candidates=16,
                             cotrain_points=256)
    batch_occ = dict(batch_rgb, occ_floor=np.float32(0.65))
    check("occ_train_step",
          lambda m_: train_once(m_, dataclasses.replace(rc, n_samples=8), tc_rgb, batch_occ, 7,
                                occ=occ_cfg), mesh)

    # six steps across a --k_schedule boundary (K 4 -> 8 at step 3) with a
    # checkpoint saved (by rank 0) and restored (by every rank) under the mesh
    def trajectory(m_):
        path = [tempfile.mkdtemp(prefix="cfnerf_dryrun_ck_") if lead else None]
        if m_ is not None:
            dist.broadcast_object_list(path, src=0)
        losses = {}

        def steps(model, k, first):
            if m_ is not None:
                replicate(m_, model)
            _, rc_k = _tiny(k)
            cfg = dataclasses.replace(tc_rgb, k_samples=k)
            step, _ = make_train_step(model, rc_k, cfg, mesh=m_)
            for s in range(first, first + 3):
                b = _batch(8 * n, 0, 100 + s)
                met = step(b if m_ is None else shard_batch(m_, b),
                           torch.Generator().manual_seed(11 + s))
                losses[f"loss_{s}"] = float(met["loss"])

        model4 = _tiny(4)[0]
        steps(model4, 4, 0)
        state = {"coarse": full_state_dict(model4)}
        if lead:
            ckpt.save_checkpoint(path[0], 3, state)
        if m_ is not None:
            dist.barrier()
        model8 = _tiny(8, seed=5)[0]
        restored, start = ckpt.restore_checkpoint(ckpt.checkpoint_path(path[0], 3),
                                                  {"coarse": model8.state_dict()})
        if start != 3:
            raise RuntimeError(f"restored step {start}, saved 3")
        model8.load_state_dict(restored["coarse"])
        steps(model8, 8, 3)
        if m_ is not None:
            dist.barrier()  # every rank has read it
        if lead:
            shutil.rmtree(path[0], ignore_errors=True)
        return losses, _state(model8)

    check("k_schedule_trajectory", trajectory, mesh, TRAJECTORY_TOL)

    if n % 2 == 0:
        # two members on the (ensemble, data) mesh, each against its serial step
        members = (0, 1)
        stacked = {k: np.stack([v] * len(members)) for k, v in batch_rgb.items()}

        def ensemble(m_):
            if m_ is None:
                out = {}
                for m in members:
                    step, _ = make_train_step(_tiny(seed=m)[0], rc, tc_rgb)
                    model = step.optimizer.param_groups[0]["params"]
                    out[m] = (metrics_of(step(batch_rgb, torch.Generator().manual_seed(20 + m))),
                              [p.detach().numpy().copy() for p in model])
            else:
                mine = [int(m) for m in pens.shard_members(m_, np.asarray(members))]
                models = [replicate(m_, _tiny(seed=m)[0]) for m in mine]
                estep, opts = pens.make_ensemble_train_step(models, rc, tc_rgb, len(mine),
                                                            mesh=m_)
                met = estep(pens.shard_member_batch(m_, stacked),
                            [torch.Generator().manual_seed(20 + m) for m in mine])
                local = {m: ({k: float(v[j]) for k, v in met.items()},
                             [p.detach().numpy().copy() for p in opts[j].param_groups[0]["params"]])
                         for j, m in enumerate(mine)}
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, local)
                out = {m: r[m] for r in every for m in r}
            return ({f"m{m}_{k}": v for m in members for k, v in out[m][0].items()},
                    {f"m{m}.{i}": p for m in members for i, p in enumerate(out[m][1])})

        check("ensemble_step", ensemble, pens.create_ensemble_mesh(2, n))
        # the trunk's widths over a model axis of 2
        check("tensor_parallel_step",
              lambda m_: train_once(m_, rc, tc_rgb, batch_rgb, 6),
              create_mesh(n, model_parallel=2))
    return errors


def dryrun_multichip(n_devices: int, *, timeout: Optional[float] = 900.0,
                     init_dir: Optional[str] = None) -> Dict[str, str]:
    """JAX's dryrun_multichip on the CPU: n_devices gloo ranks run, in JAX's
    order, the data-parallel step (COLMAP depth rays), the hierarchical step,
    the n_inner = 2 loop, the fused step (the render core's plain version,
    JAX's interpret), the mesh render, grid-placed serving, the occ training
    step (an annealed floor in the batch), six steps across a --k_schedule
    boundary with a checkpoint saved and restored under the mesh, and with
    an even n_devices the ensemble step on create_ensemble_mesh(2, n) and the
    (data, model = 2) tensor-parallel step; each against the same work on
    one device, at JAX's tolerances (STEP_TOL; TRAJECTORY_TOL for the
    n_inner loop and the trajectory, several steps).  Prints one line a check; returns {check: '' when it
    matched, else what differs}.  timeout / init_dir: launch's."""
    from cfnerf_torch.parallel.mesh import launch

    return launch(_dryrun_rank, n_devices, n_devices, device="cpu", timeout=timeout,
                  init_dir=init_dir)[0]
