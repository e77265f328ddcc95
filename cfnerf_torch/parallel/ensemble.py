"""Ensemble-parallel training: every member's step in one call; counterpart
of cfnerf_tpu/parallel/ensemble.py.

Ensemble members are independent until the mixture eval: no math crosses
members in training.  The JAX package stacks a member axis onto params,
optimizer state, batches and keys and vmaps its step over it.  Here each
member keeps its own nets, Adam, schedule and generator, and the ensemble
step runs the M single-member steps of train/step.py:make_train_step one
after another inside one call: what the vmap computes, member by member.
torch.func.vmap cannot take that step: the port's autograd Functions
(render core, flow stack, trunk) have old-style forward(ctx, ...) and no
vmap rule, and the CUDA kernels take no member axis.

  * stack_members / unstack_member: a list of (nested) state dicts to one of
    (M, ...) tensors and back, JAX's host-side stacking;
  * member_generators: the members' generators, JAX's member_keys;
  * make_ensemble_train_step / make_ensemble_train_loop: the step over
    (M, R, ...) batches and M generators, metrics stacked to (M,) (the loop:
    (n_inner, M)).

A device mesh (JAX's create_ensemble_mesh, shard_members,
shard_member_batch, shard_member_stacked_batch) comes with slice 8c.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train.step import Metrics, TrainConfig, make_train_step
from cfnerf_torch.utils.device import DeviceLike, resolve_device


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
    """Member m's slice of a batch leaf or a seam: x[m]; a tuple (eps) or a
    dict (a batch) slices each entry."""
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: _member(v, m) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_member(v, m) for v in x)
    return x[m]


def _per_member(x, n_members: int, what: str) -> list:
    if x is None:
        return [None] * n_members
    x = list(x)
    if len(x) != n_members:
        raise ValueError(f"{what}: {len(x)} given for {n_members} members")
    return x


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
    first (eps: a pair of (M, K, 1) and (M, K, 3)).  With `occ`,
    step.install_proposals(props) loads each member's distilled proposal
    (a ProposalMLP or its state dict) and restarts its Adam, JAX's
    _wrap_state.  step.members holds the single-member steps.

    mesh: a device mesh raises NotImplementedError (slice 8c)."""
    if mesh is not None:
        raise NotImplementedError("an ensemble over a device mesh comes with slice 8c")
    models = _per_member(model, n_members, "model")
    fines = _per_member(model_fine, n_members, "model_fine")
    carried = _per_member(optimizers, n_members, "optimizers")
    props = _per_member(proposals, n_members, "proposals")
    members = [make_train_step(models[m], render_config, cfg, model_fine=fines[m], occ=occ,
                               optimizer=carried[m], proposal=props[m])[0]
               for m in range(n_members)]

    def step(batch: Mapping, generators: Sequence[Optional[torch.Generator]], **seams) -> Metrics:
        gens = _per_member(generators, n_members, "generators")
        out = [s(_member(batch, m), gens[m], **{k: _member(v, m) for k, v in seams.items()})
               for m, s in enumerate(members)]
        return {k: torch.stack([o[k] for o in out]) for k in out[0]}

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
    if occ is not None:
        loop.install_proposals = step.install_proposals
        loop.proposals = step.proposals
        loop.prop_optimizers = step.prop_optimizers
    return loop, optimizers
