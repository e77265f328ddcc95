"""Ensemble-parallel training: every member's step in one call; counterpart
of cfnerf_tpu/parallel/ensemble.py.

Ensemble members are independent until the mixture eval: no math crosses
members in training.  The JAX package stacks a member axis onto params,
optimizer state, batches and keys and vmaps its step over it, and where the
step reaches a Pallas kernel, pallas_call's batching rule gives that kernel
a leading member axis in its grid: one launch covers every member.  Here
each member keeps its own nets, Adam, schedule, generator and checkpoint
format, and the ensemble step is one of two, chosen once when it is built
(printed, and kept as step.batched):

  * the member-batched step, JAX's vmap written out, for NeRFFlows of any
    flow family on the fused (triangular) or the unfused render, and for
    the baselines (nerf, nerf_dropout, nerf_wild; unfused), placed (the occ
    stage) or not, with or without remat (no fine pass;
    train/step.py:batched_step_refusal), its loss
    train/step.py:make_batched_loss, which is also the one-member step
    of these configurations: each member's draws from its own generator in
    its serial step's order (the placement's u or the jitter, the base
    draws, the density noise); each member's placement on its own rays and
    proposal; the rays' preparation, the positional encoding and the
    sample intervals once over all M members' rays; the trunk ("pallas" and
    "interpret": the members' stacked trunks through the trunk kernels, one
    launch forward and one backward), the render core (one launch forward,
    one backward, the z0 gradients per member) or, unfused, the flow stack
    (one launch a chain each way, each member's z0 gradient summed over its
    own points) with a member axis; the householder, orthogonal and planar
    flows once on the members' joined points; the "xla" trunk's and the
    amortizers' products, IAF's MADE layers, the baselines' nets (no
    kernel: nerf_dropout's K draws each on the member's own masks) and the
    unfused composite, member by member, which keeps their bits; with remat the members'
    forward under one activation checkpoint; each member's loss scored on
    its own rays, one backward on their sum, then each member's own update (its Adam and schedule; under a
    mesh its gradient's all-reduce over its data ranks first); in the occ
    stage then one density query of the M updated fields (the flow stack
    one launch a chain) and each member's proposal's own Adam step
    (train/step.py:make_batched_cotrain).  Member m's parameters get the
    gradients of its serial step: on the CPU, where the kernels' plain
    versions run member by member, bitwise.  A batched launch that fails
    raises; nothing falls back to the loop.  On a CUDA device, without a
    mesh, occ or remat, for NeRFFlows members, the whole step (forward,
    backward and every member's Adam) is one CUDA graph (train/graph.py),
    as each member's own step would be;
  * the per-member loop for every other configuration (hierarchical
    sampling, members that differ): the M
    single-member steps of train/step.py:make_train_step one after another
    inside one call.

  * stack_members / unstack_member: a list of (nested) state dicts to one of
    (M, ...) tensors and back, JAX's host-side stacking;
  * member_generators: the members' generators, JAX's member_keys;
  * make_ensemble_train_step / make_ensemble_train_loop: the step over
    (M, R, ...) batches and M generators, metrics stacked to (M,) (the loop:
    (n_inner, M));
  * create_ensemble_mesh / shard_members / shard_member_batch /
    shard_member_stacked_batch: the (ensemble, data) mesh over several
    devices (parallel/mesh.py).  A rank holds a contiguous block of the
    members, as P('ensemble') places them, and its rows of their ray axis;
    its members' step runs on its data shard, each member's gradient
    all-reduced over that member's data ranks only: no collective crosses
    members.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.lr_scheduler import LambdaLR

from cfnerf_torch.parallel.mesh import (
    DATA_AXIS,
    ENSEMBLE_AXIS,
    Mesh,
    map_leaves,
    block,
    gcd_split,
)
from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.render.renderer import unfused
from cfnerf_torch.train.graph import StepGraph
from cfnerf_torch.train.step import (
    Metrics,
    TrainConfig,
    batched_step_refusal,
    make_batched_cotrain,
    make_batched_loss,
    make_train_step,
)
from cfnerf_torch.utils.device import DeviceLike, resolve_device
from cfnerf_torch.utils.trace import count, span


def create_ensemble_mesh(n_members: int, n_devices: Optional[int] = None) -> Mesh:
    """The (ensemble, data) mesh for M members over the group's ranks: the
    ensemble axis gets gcd(M, n) ranks, so the members split evenly over it
    (several a rank when M exceeds it), the rest form each member's data
    axis.  M = 1 is the plain data mesh (an ensemble axis of 1).  n_devices
    defaults to, and must equal, the group's size."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks")
    return Mesh((ENSEMBLE_AXIS, DATA_AXIS), gcd_split(n_members, n))


def shard_members(mesh: Mesh, tree):
    """This rank's contiguous block of the member axis (axis 0) of every
    leaf of a stacked (M, ...) tree, P('ensemble')'s placement; rank-0
    leaves are kept whole."""
    e, i = mesh.shape[ENSEMBLE_AXIS], mesh.index(ENSEMBLE_AXIS)
    return map_leaves(lambda x: block(x, 0, i, e) if np.ndim(x) >= 1 else x, tree)


def shard_member_batch(mesh: Mesh, batch):
    """A stacked batch's share: (M, R, ...) leaves to this rank's members and
    its rows of their ray axis; (M,) leaves (per-member scalars, e.g. an
    annealed occ floor) to its members."""
    n, d = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    batch = shard_members(mesh, batch)
    return map_leaves(lambda x: block(x, 1, d, n) if np.ndim(x) >= 2 else x, batch)


def shard_member_stacked_batch(mesh: Mesh, batches):
    """The same for (n_inner, M, R, ...) leaves: the inner-step axis whole."""
    e, i = mesh.shape[ENSEMBLE_AXIS], mesh.index(ENSEMBLE_AXIS)
    n, d = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)

    def share(x):
        if np.ndim(x) < 2:
            return x
        x = block(x, 1, i, e)
        return block(x, 2, d, n) if np.ndim(x) >= 3 else x

    return map_leaves(share, batches)


def stack_members(trees: Sequence[Mapping]) -> dict:
    """Stack the members' state dicts (nested mappings of tensors or arrays)
    on a new leading member axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: stack_members([t[k] for t in trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in trees])


def unstack_member(tree: Mapping, m: int) -> dict:
    """Member m's state dict out of a stacked one, each tensor a copy of its
    own (a view would keep, and torch.save would write, every member)."""
    if isinstance(tree, Mapping):
        return {k: unstack_member(v, m) for k, v in tree.items()}
    return torch.as_tensor(tree)[m].clone()


def member_generators(seeds: Sequence[int], device: DeviceLike = None) -> List[torch.Generator]:
    """One generator a member, on the device (the CUDA device unless
    device="cpu"), seeded in order."""
    dev = resolve_device(device)
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]


def _member(x, m: int):
    """Member m's slice of a batch leaf or a seam: x[m]; a tuple or a list
    (NeRFFlows' eps pair, nerf_dropout's mask lists, noise's passes) or a
    dict (a batch) slices each entry."""
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: _member(v, m) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_member(v, m) for v in x)
    return x[m]


def _per_member(x, n_members: int, what: str) -> list:
    if x is None:
        return [None] * n_members
    x = list(x)
    if len(x) != n_members:
        raise ValueError(f"{what}: {len(x)} given for {n_members} members")
    return x


def _batched_step(members: Sequence[Callable], models: Sequence[torch.nn.Module],
                  render_config: RenderConfig, cfg: TrainConfig, mesh, occ) -> Callable:
    """The member-batched step (the module docstring) over the members'
    single-member steps `members`, whose updates, schedules, proposals and
    proposal optimizers it uses.  Where every member's own step would be a
    CUDA graph (train/step.py:graph_refusal; no mesh, no occ), the batched
    step is one too (train/graph.py), over every member's Adam: its call
    with the captured shapes and generators a replay, another eager."""
    proposals = None if occ is None else [s.proposal for s in members]
    loss_fn = make_batched_loss(models, render_config, cfg, mesh, occ, proposals)
    cotrain = None if occ is None else make_batched_cotrain(
        models, render_config, occ, proposals, [s.prop_optimizer for s in members], mesh)
    M = len(models)

    def forward(batch: Mapping, gens: Sequence[Optional[torch.Generator]], z_vals=None,
                eps=None, place_u=None, noise=None) -> Tuple[torch.Tensor, List[Metrics]]:
        """The members' losses summed, and each member's metrics."""
        # noise holds one tensor a render pass, and these renders have one
        scored = loss_fn(batch, gens, z_vals=[_member(z_vals, m) for m in range(M)],
                         eps=[_member(eps, m) for m in range(M)],
                         place_u=[_member(place_u, m) for m in range(M)],
                         noise=[None if noise is None else noise[0][m] for m in range(M)])
        # d(sum)/d(loss_m) is exactly 1: each member's gradients are its own step's
        return (torch.stack([loss for loss, _ in scored]).sum(),
                [{k: v.detach() for k, v in metrics.items()} for _, metrics in scored])

    def stacked(out: List[Metrics]) -> Metrics:
        return {k: torch.stack([o[k] for o in out]) for k in out[0]}

    graph = None
    if mesh is None and occ is None and all(s.graph_refusal is None for s in members):
        def graphed_loss(batch, gens, seams):
            loss, out = forward(batch, list(gens), **seams)
            return loss, stacked(out)

        graph = StepGraph(graphed_loss, [s.optimizer for s in members],
                          next(models[0].parameters()).device)

    def step(batch: Mapping, generators: Sequence[Optional[torch.Generator]], *,
             z_vals=None, eps=None, place_u=None, noise=None, prop_pts=None,
             **seams) -> Metrics:
        given = sorted(k for k, v in seams.items() if v is not None)
        if given:
            raise ValueError(f"the member-batched step has no draws for the seams {given}")
        gens = _per_member(generators, M, "generators")
        if graph is not None:
            with span("cfnerf.train.stage"):
                staged = graph.stage(batch, gens, dict(z_vals=z_vals, eps=eps, noise=noise))
            if staged:
                with span("cfnerf.train.replay"):
                    metrics = graph.replay()
                with span("cfnerf.train.update"):
                    for s in members:
                        s.scheduler.step()
                return metrics
            count("train.graph_eager")  # another call than the captured one
        for s in members:
            s.optimizer.zero_grad(set_to_none=True)
        loss, scored = forward(batch, gens, z_vals, eps, place_u, noise)
        loss.backward()
        out = []
        for s, metrics in zip(members, scored):
            s.update()
            out.append(metrics if mesh is None else s.global_metrics(metrics))
        if cotrain is not None:
            for metrics, prop_loss in zip(out, cotrain(
                    gens, [_member(prop_pts, m) for m in range(M)])):
                metrics["prop_loss"] = prop_loss
        return stacked(out)

    step.graphed = graph is not None
    return step


def _batched_launches(render_config: RenderConfig, occ, model: torch.nn.Module,
                      remat: bool) -> str:
    """What the member-batched step runs, and how much of it once for all
    members."""
    baseline = isinstance(model, KSampleBaseline)
    if baseline:  # plain nn.Linear nets, each member's own
        what = f"the {model.kind} nets member by member, no kernel"
    elif model.type_flows == "IAF":  # the MADE layers are each member's own
        what = "the IAF flows member by member; one trunk launch a pass for all"
    elif model.type_flows != "triangular":
        what = (f"the {model.type_flows} flows once on the joined points; one trunk launch "
                "a pass for all")
    elif unfused(render_config):
        what = "one trunk and flow-stack launch a chain and pass for all"
    else:
        what = "one trunk and render-core launch a pass for all"
    if remat:
        what = "remat, the forward recomputed in the backward; " + what
    if occ is not None:
        what += ("; the co-training's density query so too" if baseline else
                 "; the co-training's density query one flow-stack launch a chain for all")
    return what


def make_ensemble_train_step(
    model: Sequence[torch.nn.Module],
    render_config: RenderConfig,
    cfg: TrainConfig,
    n_members: int,
    mesh=None,
    model_fine: Optional[Sequence[torch.nn.Module]] = None,
    occ=None,
    optimizers: Optional[Sequence[Tuple[torch.optim.Adam, LambdaLR]]] = None,
    proposals: Optional[Sequence[tuple]] = None,
) -> Tuple[Callable, List[torch.optim.Adam]]:
    """Returns (step, optimizers): the members' step and their Adams.

    `model` is the members' nets, n_members of them, each holding its
    member's parameters (JAX's stacked params_M); `model_fine` their fine
    nets, where the render is hierarchical.  Member m's step is
    make_train_step(model[m], render_config, cfg, model_fine=model_fine[m],
    occ=occ, optimizer=optimizers[m], proposal=proposals[m]): `optimizers`
    and `proposals` carry each member's (Adam, schedule) and occ (proposal,
    Adam) pairs over from an earlier stage's step, as make_train_step's
    `optimizer` and `proposal` do.

    step(batch, generators, *, z_vals=None, eps=None, eps_fine=None,
    pdf_u=None, noise=None, place_u=None, prop_pts=None) -> metrics takes
    member m's step on batch leaves [m] ((M, R, ...) rays and targets; an
    (M,) occ_floor is each member's floor) with generators[m], and returns
    each metric stacked to (M,).  A seam, where given, has the member axis
    first (eps: NeRFFlows' pair of (M, K, 1) and (M, K, 3), nerf_wild's
    (M, K, 3), nerf_dropout's K lists of (M, n_points, width) masks in
    NeRFDropout.mask_shapes order; noise one (M, R, S, K) tensor a pass);
    the member-batched step takes z_vals, eps, place_u,
    noise and prop_pts, the draws its configurations make.  With
    `occ`, step.install_proposals(props) loads each member's distilled
    proposal (a ProposalMLP or its state dict) and restarts its Adam, JAX's
    _wrap_state.  step.members holds the single-member steps, whose
    optimizers, schedules and updates both flavours use; step.batched
    says which flavour runs (the module docstring), chosen here once and
    printed.

    With `mesh` (create_ensemble_mesh) the members are this rank's block
    (shard_members) and n_members their count; the batch is its share
    (shard_member_batch), and each member's step is make_train_step's over
    the mesh's data axis: its gradient all-reduced over the member's data
    ranks only, its metrics their means."""
    models = _per_member(model, n_members, "model")
    fines = _per_member(model_fine, n_members, "model_fine")
    carried = _per_member(optimizers, n_members, "optimizers")
    props = _per_member(proposals, n_members, "proposals")
    members = [make_train_step(models[m], render_config, cfg, mesh=mesh, model_fine=fines[m],
                               occ=occ, optimizer=carried[m], proposal=props[m])[0]
               for m in range(n_members)]
    refusal = batched_step_refusal(models, render_config, cfg, model_fine, occ)
    if refusal is None:
        step = _batched_step(members, models, render_config, cfg, mesh, occ)
        launches = _batched_launches(render_config, occ, models[0], cfg.remat)
        if step.graphed:
            launches += "; one CUDA graph a step"
        print(f"ensemble step: {n_members} members batched ({launches})", flush=True)
    else:
        def step(batch: Mapping, generators: Sequence[Optional[torch.Generator]],
                 **seams) -> Metrics:
            gens = _per_member(generators, n_members, "generators")
            out = [s(_member(batch, m), gens[m], **{k: _member(v, m) for k, v in seams.items()})
                   for m, s in enumerate(members)]
            return {k: torch.stack([o[k] for o in out]) for k in out[0]}

        print(f"ensemble step: {n_members} members one after another ({refusal})", flush=True)
    step.batched = refusal is None
    step.members = members
    if occ is not None:
        def install_proposals(props) -> None:
            for s, p in zip(members, _per_member(props, n_members, "proposals")):
                s.install_proposal(p)

        step.install_proposals = install_proposals
        step.proposals = [s.proposal for s in members]
        step.prop_optimizers = [s.prop_optimizer for s in members]
    return step, [s.optimizer for s in members]


def make_ensemble_train_loop(
    model: Sequence[torch.nn.Module],
    render_config: RenderConfig,
    cfg: TrainConfig,
    n_members: int,
    mesh=None,
    n_inner: int = 10,
    model_fine: Optional[Sequence[torch.nn.Module]] = None,
    occ=None,
    optimizers: Optional[Sequence[Tuple[torch.optim.Adam, LambdaLR]]] = None,
    proposals: Optional[Sequence[tuple]] = None,
) -> Tuple[Callable, List[torch.optim.Adam]]:
    """Returns (loop, optimizers).  loop(batches, generators) takes n_inner
    ensemble steps over batches stacked (n_inner, M, ...) and returns the
    metrics stacked (n_inner, M).  Each member's generator is consumed as
    make_train_loop consumes a run's: its n_inner steps in turn (JAX splits
    each member's key upfront; torch has no such split).  The rest as in
    make_ensemble_train_step."""
    step, optimizers = make_ensemble_train_step(model, render_config, cfg, n_members, mesh,
                                                model_fine, occ, optimizers, proposals)

    def loop(batches: Mapping, generators: Sequence[Optional[torch.Generator]]) -> Metrics:
        steps = [step(_member(batches, j), generators) for j in range(n_inner)]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    loop.members = step.members
    loop.batched = step.batched
    if occ is not None:
        loop.install_proposals = step.install_proposals
        loop.proposals = step.proposals
        loop.prop_optimizers = step.prop_optimizers
    return loop, optimizers
