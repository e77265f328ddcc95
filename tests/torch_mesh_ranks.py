"""Rank functions of the port's mesh tests (tests/test_torch_mesh.py).  The
ranks are spawned processes that import this module by name, so it imports
torch and the port only, never JAX: the tests compute JAX's numbers in
their own process and hand them over as numpy arrays."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.entry import _tiny
from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.models.factory import init_params
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.parallel import ensemble as pens
from cfnerf_torch.parallel import mesh as pmesh
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train.step import TrainConfig, make_train_step


def _np(t):
    return t.detach().numpy().copy()


def _mesh_shapes():
    """create_mesh's shapes over the 4 ranks, and create_ensemble_mesh's
    for M = 2, 3, 4."""
    return {"default": pmesh.create_mesh().shape,
            "four": pmesh.create_mesh(4).shape,
            "model_parallel_2": pmesh.create_mesh(model_parallel=2).shape,
            **{f"ensemble_{m}": pens.create_ensemble_mesh(m, 4).shape for m in (2, 3, 4)}}


def _tp_leaves(mesh):
    """The parameter names that shard_params_tp splits, flat and in the
    hierarchical pair, and the refusal of a net on the trunk kernels."""
    def split(net):
        pmesh.shard_params_tp(mesh, net)
        return sorted(f"{name}.{leaf}" for name, m in net.named_modules()
                      if isinstance(m, pmesh.ColumnParallelLinear) for leaf in ("weight", "bias"))

    flat = split(_tiny()[0])
    coarse, fine = split(_tiny()[0]), split(_tiny(seed=2)[0])
    kernels = NeRFFlows(net_depth=4, net_width=64, skips=(2,), h_alpha_size=16, h_rgb_size=16,
                        n_flows=2, k_samples=4, trunk_impl="pallas")
    try:
        pmesh.shard_params_tp(mesh, kernels)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"flat": flat, "coarse": coarse, "fine": fine, "pallas_refused": refused}


def _jax_dp_step(mesh, jax_in):
    """The 4-rank data-parallel step on JAX's weights and draws (z_vals from
    JAX's uniforms over the whole batch, JAX's eps): global metrics, reduced
    gradients and updated parameters."""
    model = NeRFFlows(**jax_in["model_kw"])
    model.load_state_dict(nerf_flows_state_dict_from_jax(jax_in["params"], jax_in["test_eps"]))
    step, _ = make_train_step(model, RenderConfig(n_samples=jax_in["n_samples"]),
                              TrainConfig(**jax_in["train_kw"]), mesh=mesh)
    metrics = step(pmesh.shard_batch(mesh, jax_in["batch"]), None, z_vals=jax_in["z_vals"],
                   eps=jax_in["eps"])
    return ({k: float(v) for k, v in metrics.items()},
            {k: _np(p.grad) for k, p in model.named_parameters() if p.grad is not None},
            {k: _np(p) for k, p in model.named_parameters()})


def _dropout(seed):
    """A nerf_dropout member at the file's narrowest widths (D2/W32, K4)."""
    return init_params(KSampleBaseline("nerf_dropout", 4, net_depth=2, net_width=32,
                                       skips=(1,), test_eps_seed=seed), seed=seed)


def _ensemble_vs_serial(n_members, batch, rc, cfg, make=lambda seed: _tiny(seed=seed)[0]):
    """Each member's step on create_ensemble_mesh(M, 4) (its block of members
    on each rank) and, on rank 0, its serial one-device step: {member:
    (metrics, params)} for both, gathered to every rank.  make(seed) builds
    member `seed`'s net (default: the tiny NeRFFlows)."""
    mesh = pens.create_ensemble_mesh(n_members, 4)
    members = np.arange(n_members)
    mine = [int(m) for m in pens.shard_members(mesh, members)]
    models = [pmesh.replicate(mesh, make(m)) for m in mine]
    step, opts = pens.make_ensemble_train_step(models, rc, cfg, len(mine), mesh=mesh)
    stacked = {k: np.stack([v] * n_members) for k, v in batch.items()}
    met = step(pens.shard_member_batch(mesh, stacked),
               [torch.Generator().manual_seed(20 + m) for m in mine])
    local = {m: ({k: float(v[j]) for k, v in met.items()},
                 [_np(p) for p in opts[j].param_groups[0]["params"]])
             for j, m in enumerate(mine) if mesh.index(pmesh.DATA_AXIS) == 0}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    on_mesh = {m: r[m] for r in every for m in r}
    serial = {}
    if dist.get_rank() == 0:
        for m in members:
            s, _ = make_train_step(make(int(m)), rc, cfg)
            got = s(batch, torch.Generator().manual_seed(20 + int(m)))
            serial[int(m)] = ({k: float(v) for k, v in got.items()},
                              [_np(p) for p in s.optimizer.param_groups[0]["params"]])
    return {"shape": mesh.shape, "mesh": on_mesh, "serial": serial, "n": n_members}


def checks(rank, jax_in, ens_batch):
    """Every check of test_torch_mesh.py that needs the 4 ranks; rank 0's
    results."""
    mesh = pmesh.create_mesh(4)
    out = {"shapes": _mesh_shapes(),
           "tp_leaves": _tp_leaves(pmesh.create_mesh(4, model_parallel=2)),
           "jax_dp": _jax_dp_step(mesh, jax_in)}
    _, rc = _tiny()
    cfg = TrainConfig(H=8, W=8, focal=10.0, ndc=False, near=0.5, far=4.0, k_samples=4,
                      beta1=0.01)
    out["ensemble"] = {m: _ensemble_vs_serial(m, ens_batch, rc, cfg) for m in (2, 3)}
    # nerf_dropout's masks drawn at the whole batch's shape, cut to a rank's rows
    out["ensemble"]["nerf_dropout"] = _ensemble_vs_serial(
        2, ens_batch, dataclasses.replace(rc, fused="off"),
        dataclasses.replace(cfg, loss_mode="mse"), make=_dropout)
    return out
