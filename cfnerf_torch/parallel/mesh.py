"""Several devices over torch.distributed; counterpart of
cfnerf_tpu/parallel/mesh.py.

Rays are embarrassingly parallel: no CF-NeRF math crosses rays.  The JAX
package lays a `data` mesh axis over the devices, shards the ray axis of
every batch, replicates the model and lets jit insert one gradient
all-reduce a step; a (data, model) mesh splits the trunk's widths over the
`model` axis.  PyTorch has no SPMD compiler, so here the mesh is one
process a device (a rank), and the code moves the tensors itself:

  * launch(fn, n_devices, *args, device=None): runs fn(rank, *args) in
    n_devices processes, one CUDA device each over NCCL (device None or
    "cuda"), every rank on one card over gloo (device "cuda:k"), or on the
    CPU over gloo (device "cpu"); inside a torchrun job (RANK and
    WORLD_SIZE set) it joins that job's group instead.  The parent waits
    with a deadline and raises, naming the rank and its traceback, when a
    rank fails, dies or outlives the deadline; the other ranks are killed;
  * create_mesh(n_devices, model_parallel=): this rank's view of the
    (data, model) grid, the model axis innermost, as in JAX;
  * shard_batch / shard_stacked_batch: this rank's rows of the ray axis;
  * replicate: the parameters and buffers broadcast from the first rank;
  * shard_params_tp: the wide layers as column-parallel layers (this model
    rank's output columns; the input's gradient summed and the output
    gathered over the model axis).  The trunk kernels take packed whole
    widths, so a net with trunk_impl "pallas" or "interpret" is refused;
  * all_gather / full_state_dict: whole tensors back from their shards.

The step (train/step.py) draws every per-ray random number at the whole
batch's shape and keeps its rows (ops/sampling.py:per_ray), all-reduces the
mean gradient over the data axis once a step and returns the global mean
metrics, so N ranks compute what one run over the whole batch computes.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
ENSEMBLE_AXIS = "ensemble"
# a collective that waits longer than this raises in the ranks
COLLECTIVE_TIMEOUT_S = 600.0
# launch's deadline when the caller gives none (None: no deadline)
DEFAULT_TIMEOUT_S: Optional[float] = None
# how long a rank's report may lag its exit before the rank counts as lost
_EXIT_GRACE_S = 5.0
# the wide modules, matched at any depth (JAX's mesh.py:112-118)
_WIDE = ("feature_linear", "views_linear", "h_alpha_linear", "h_rgb_linear")


# ------------------------------------------------------------------ launch


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank` under launch(device=): "cpu" -> the CPU; None or
    "cuda" -> one card a rank, cuda:rank (in a torchrun job cuda:LOCAL_RANK);
    "cuda:k" -> cuda:k for every rank."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return dev


def _backend(device) -> str:
    """NCCL with one card a rank; gloo on the CPU and for several ranks on one
    card (NCCL refuses two ranks on one GPU)."""
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"


def _rank_main(fn, rank, n_devices, args, device, init_method, reports):
    """One rank: join the group, run fn, report (rank, ok, pickled result or
    traceback).  Ranks > 0 print nothing.  A failing rank reports before any
    teardown, so a peer stuck in a collective cannot hide its traceback."""
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # the ranks are the parallelism
        dist.init_process_group(
            _backend(device), init_method=init_method, rank=rank, world_size=n_devices,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        result = fn(rank, *args)
        payload = pickle.dumps(result)
    except Exception:
        reports.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()
    reports.put((rank, True, payload))


def _join_torchrun(fn, n_devices, args, device):
    """Run fn in this process as a rank of the torchrun job; every rank's
    results, gathered."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != n_devices:
        raise ValueError(f"the torchrun job has {world} ranks, the mesh asks for {n_devices}")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(device), init_method="env://",
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = fn(rank, *args)
        results: List[Any] = [None] * world
        dist.all_gather_object(results, result)
    finally:
        dist.destroy_process_group()
    return results


def launch(fn: Callable, n_devices: int, *args, device=None, timeout: Optional[float] = None,
           init_dir: Optional[str] = None) -> List[Any]:
    """Run fn(rank, *args) on n_devices ranks and return their results in
    rank order.  fn must be importable (a module-level function) and its
    arguments and result picklable.

    device: None or "cuda" -> NCCL, rank r on cuda:r; "cuda:k" -> gloo, every
    rank on cuda:k; "cpu" -> gloo on the CPU, one thread a rank.  The group
    meets in a file store under init_dir (a fresh temporary directory by
    default, removed after), so concurrent launches never collide.
    timeout: seconds the parent waits for every rank (default
    DEFAULT_TIMEOUT_S; None there: no deadline, while a collective still
    raises after COLLECTIVE_TIMEOUT_S).  A rank that raises, dies or is
    still running at the deadline makes launch kill every rank and raise
    RuntimeError naming it (with its traceback).  Ranks > 0 print nothing.
    With RANK and WORLD_SIZE in the environment (torchrun), this
    process joins that job as its rank instead of spawning."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _join_torchrun(fn, n_devices, args, device)
    if _backend(device) == "nccl" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks over NCCL need {n_devices} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    owned = init_dir is None
    store_dir = tempfile.mkdtemp(prefix="cfnerf_pg_") if owned else init_dir
    store = os.path.join(store_dir, f"pg_{os.getpid()}_{time.monotonic_ns()}")
    reports = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n_devices, args, device, f"file://{store}", reports))
             for r in range(n_devices)]
    timeout = DEFAULT_TIMEOUT_S if timeout is None else timeout
    deadline = None if timeout is None else time.monotonic() + timeout
    results: Dict[int, Any] = {}
    lost_since: Dict[int, float] = {}
    try:
        for p in procs:
            p.start()
        while len(results) < n_devices:
            try:
                rank, ok, payload = reports.get(timeout=0.2)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in results or p.exitcode is None:
                        continue
                    # its report may still be in the pipe: give it a grace
                    if now - lost_since.setdefault(r, now) > _EXIT_GRACE_S:
                        raise RuntimeError(f"rank {r} of {n_devices} exited with code "
                                           f"{p.exitcode} and no result")
                if deadline is not None and now > deadline:
                    missing = sorted(set(range(n_devices)) - set(results))
                    raise RuntimeError(f"ranks {missing} of {n_devices} still running after "
                                       f"the {timeout} s deadline")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_devices} failed:\n{payload}")
            results[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=_EXIT_GRACE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        reports.close()
        if owned:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [results[r] for r in range(n_devices)]


# ------------------------------------------------------------------ mesh


class Mesh:
    """This rank's view of an (outer, inner) grid over the group's ranks,
    rank = outer_index * inner + inner_index: the axes' sizes (`shape`, a
    dict as JAX's Mesh.shape), this rank's index on each axis (`index`), and
    the process group along each axis (`group`: the ranks that differ from
    this one only on that axis).  Every rank creates every group, in one
    order, as torch.distributed.new_group requires."""

    def __init__(self, axis_names: Tuple[str, str], sizes: Tuple[int, int]):
        outer, inner = sizes
        world = dist.get_world_size()
        if outer * inner != world:
            raise ValueError(f"a {outer} x {inner} mesh over {world} ranks")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (outer, inner)))
        self.rank = dist.get_rank()
        o, i = divmod(self.rank, inner)
        self._index = {self.axis_names[0]: o, self.axis_names[1]: i}
        self._ranks, self._groups = {}, {}
        for a in range(outer):  # along the inner axis
            ranks = [a * inner + b for b in range(inner)]
            group = dist.new_group(ranks)
            if a == o:
                self._ranks[self.axis_names[1]], self._groups[self.axis_names[1]] = ranks, group
        for b in range(inner):  # along the outer axis
            ranks = [a * inner + b for a in range(outer)]
            group = dist.new_group(ranks)
            if b == i:
                self._ranks[self.axis_names[0]], self._groups[self.axis_names[0]] = ranks, group

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks along `axis` through this rank, in axis order."""
        return self._ranks[axis]


def check_mesh_size(n_devices: int, model_parallel: int = 1) -> None:
    """JAX's refusal: the devices must divide by model_parallel."""
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")


def create_mesh(n_devices: Optional[int] = None, *, model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over the group's ranks, shaped
    (n / model_parallel, model_parallel), the model axis innermost (its
    collectives between neighbouring ranks, as JAX puts them on the fastest
    links).  n_devices defaults to, and must equal, the group's size."""
    if n_devices is not None:
        check_mesh_size(int(n_devices), model_parallel)
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: run it under launch()")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    check_mesh_size(n, model_parallel)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a group of {world} ranks")
    return Mesh((DATA_AXIS, MODEL_AXIS), (n // model_parallel, model_parallel))


def block(x, axis: int, part: int, n: int):
    """This data rank's contiguous block of x along `axis`."""
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"an axis of {size} rows does not split over a data axis of {n}")
    step = size // n
    index = [slice(None)] * axis + [slice(part * step, (part + 1) * step)]
    return x[tuple(index)]


def map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _split(mesh: Mesh, tree, axis: int, min_ndim: int, data_axis: str = DATA_AXIS):
    n, d = mesh.shape[data_axis], mesh.index(data_axis)
    return map_leaves(lambda x: block(x, axis, d, n) if np.ndim(x) >= min_ndim else x, tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of the ray axis (axis 0) of every array of a batch
    (numpy arrays or tensors, in dicts, lists or tuples); rank-0 leaves
    (per-step scalars, e.g. the annealed occ floor) are kept whole."""
    return _split(mesh, batch, 0, 1)


def shard_stacked_batch(mesh: Mesh, batch: Any) -> Any:
    """For stacked (n_inner, R, ...) batches: the inner-step axis whole, this
    rank's rows of the ray axis (axis 1); leaves with only the inner-step
    axis are kept whole."""
    return _split(mesh, batch, 1, 2)


@torch.no_grad()
def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast the module's parameters and buffers in place from the first
    rank of its replicas (global rank 0 on a (data, model) mesh, before any
    tensor-parallel split; the first data rank of its ensemble group on an
    (ensemble, data) mesh)."""
    if ENSEMBLE_AXIS in mesh.shape:
        group, src = mesh.group(DATA_AXIS), mesh.ranks(DATA_AXIS)[0]
    else:
        group, src = None, 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of t's shape concatenated along `dim` in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


# ------------------------------------------------------------ tensor parallel


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model axis (each model rank holds the part that flows through its
    columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOverModel(torch.autograd.Function):
    """Forward: the model ranks' output columns gathered in rank order.
    Backward: this rank's columns of the gradient, no sum (the cotangent is
    the same on every model rank: what follows the gather is replicated).
    torch.distributed.nn.functional.all_gather would sum it over the ranks
    and scale the gradient by model_parallel."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.rank, ctx.width = rank, y.shape[-1]
        return all_gather(y, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


class ColumnParallelLinear(nn.Linear):
    """The model rank's share of an nn.Linear: its out_features / model_parallel
    output columns of weight and bias.  forward(x) = the whole layer's output:
    the input through _SumGradOverModel, the local product, the columns
    gathered over the model axis.  enter / leave are the two collectives, for
    callers that compute the local product themselves (the bf16 dense of
    models/nerf_flows.py)."""

    def __init__(self, full: nn.Linear, group, rank: int, size: int):
        out = full.out_features
        if out % size:
            raise ValueError(f"a layer of {out} outputs does not split over "
                             f"model_parallel={size}")
        cols = slice(rank * (out // size), (rank + 1) * (out // size))
        super().__init__(full.in_features, out // size, device=full.weight.device,
                         dtype=full.weight.dtype)
        with torch.no_grad():
            self.weight.copy_(full.weight[cols])
            self.bias.copy_(full.bias[cols])
        self.full_out_features = out
        self.tp_group, self.tp_rank, self.tp_size = group, rank, size

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _SumGradOverModel.apply(x, self.tp_group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherOverModel.apply(y, self.tp_group, self.tp_rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.leave(super().forward(self.enter(x)))


def is_wide(name: str) -> bool:
    """A module path naming one of the layers that JAX's shard_params_tp
    splits: pts_linears.* and the heads, at any depth."""
    return any(p.startswith("pts_linear") or p in _WIDE for p in name.split("."))


def check_tensor_parallel(model_parallel: int, trunk_impl: str) -> None:
    """The trunk kernels take packed whole widths: no model axis with them."""
    if model_parallel > 1 and trunk_impl != "xla":
        raise ValueError(
            f"--model_parallel {model_parallel} splits the trunk's widths over the model "
            f"axis, and trunk_impl={trunk_impl!r} (the trunk kernels or their plain "
            "versions) takes packed whole widths; use --trunk_impl xla")


def shard_params_tp(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Tensor-parallel placement, in place: every wide nn.Linear (see
    is_wide) becomes a ColumnParallelLinear holding this model rank's output
    columns; every other parameter stays whole (replicated).  With a model
    axis of 1 the module is left as it is.  Raises ValueError for a net on
    the trunk kernels (check_tensor_parallel)."""
    size = mesh.shape.get(MODEL_AXIS, 1)
    if size == 1:
        return model
    check_tensor_parallel(size, getattr(model, "trunk_impl", "xla"))
    group, rank = mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS)
    wide = [(name, m) for name, m in model.named_modules()
            if type(m) is nn.Linear and is_wide(name)]
    for name, m in wide:
        parent_name, _, leaf = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, leaf, ColumnParallelLinear(m, group, rank, size))
    return model


@torch.no_grad()
def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict with every column-parallel layer's weight and
    bias gathered whole (a collective over the model axis: every model rank
    calls it); a module without one returns its state dict."""
    state = module.state_dict()
    for name, m in module.named_modules():
        if isinstance(m, ColumnParallelLinear):
            for leaf in ("weight", "bias"):
                key = f"{name}.{leaf}"
                state[key] = all_gather(state[key], m.tp_group, dim=0)
    return state


@torch.no_grad()
def full_optimizer_state(optimizer: torch.optim.Optimizer, *modules: nn.Module) -> dict:
    """optimizer.state_dict() with the per-parameter state (Adam's moments)
    of every column-parallel weight and bias of `modules` gathered whole, a
    collective over the model axis as full_state_dict."""
    state = optimizer.state_dict()
    split = {id(p): m for module in modules for m in module.modules()
             if isinstance(m, ColumnParallelLinear) for p in (m.weight, m.bias)}
    if not split:
        return state
    order = [p for group in optimizer.param_groups for p in group["params"]]
    for i, p in enumerate(order):
        m = split.get(id(p))
        if m is None or i not in state["state"]:
            continue
        state["state"][i] = {k: all_gather(v, m.tp_group, dim=0)
                             if torch.is_tensor(v) and v.shape == p.shape and v.dim() else v
                             for k, v in state["state"][i].items()}
    return state


# ------------------------------------------------------------ collectives


def mean_over(values: Sequence[torch.Tensor], mesh: Mesh, axis: str = DATA_AXIS):
    """The mean of each scalar over `axis`, one all-reduce for all."""
    flat = torch.stack([v.detach().reshape(()).float() for v in values])
    dist.all_reduce(flat, group=mesh.group(axis))
    return list(flat.div_(mesh.shape[axis]).unbind())


def is_writer() -> bool:
    """Rank 0 of the group writes the files (every process without a group
    too)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gcd_split(n_members: int, n_devices: int) -> Tuple[int, int]:
    """JAX's (ensemble, data) split of n_devices for M members: the
    ensemble axis gets gcd(M, n) devices."""
    e = math.gcd(max(1, n_members), n_devices)
    return e, n_devices // e
