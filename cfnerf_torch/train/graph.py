"""One CUDA graph of a training step: a step's forward, backward and Adam
update on a CUDA device (make_train_step's, or the ensemble's member-batched
step over every member's Adam), captured at the step object's first call and
replayed for every later call whose inputs match the captured one.

A replay is one cudaGraphLaunch for the whole step, so the host no longer
paces the card with autograd's and the ops' launches.  The graph holds the
same kernels as the eager step (the port's hand-written kernels, cuBLAS's
and PyTorch's), on the same shapes and in the same order: it wraps them and
replaces none.

  * inputs: the batch's leaves (f32, as the step reads them) and the seams
    handed in (z_vals, eps, ...), copied into the graph's static buffers on
    the current stream; the draws not handed in are made inside the graph
    from the call's generators, which the graph registers
    (CUDAGraph.register_generator_state): a replay reads each generator's
    seed and Philox offset at its launch and advances the offset by what
    the captured draws took, so that a replay draws the values that the
    eager step draws from the same generator, in the same order.  A call
    with other shapes, dtypes, seams or generators than the captured one,
    or with a generator on another device (its draws copied over), is not
    staged, for the caller to run eagerly;
  * capture: a warm-up forward and backward on a side stream (no update,
    its gradients dropped, the generators put back to where they were),
    Adam's state made as its lazy init makes it, then forward, backward and
    every optimizer's step() captured; the graph writes the gradients, so
    no zero_grad is needed.  Adam must be capturable, its lr a device
    tensor (make_optimizer on CUDA);
  * outputs: the metrics as fresh copies (a replay overwrites the graph's);
    after a replay .grad holds the step's gradients, the graph's buffers;
  * the hand-written kernels' launch counters count the steps' launches,
    inferred on the host: the warm-up's and the capture's are taken back,
    and each replay adds what the capture launched;
  * the first call must find no autograd graph through the parameters
    held from before (a loss kept from an eager forward): its gradient
    accumulators would tie the capture to the stream that forward ran on,
    and the capture fails (CUDA's "legacy stream" error) with a message
    that says so.

The graph reads the parameters, Adam's state and its lr tensor in place:
an update of them in place (an eager step of the same optimizer, the
schedule) is seen by the next replay, a replaced tensor
(optimizer.load_state_dict) is not.

Counters (utils/trace.py, while a profile records): train.graph_capture,
train.graph_replay.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from cfnerf_torch.utils.trace import count, launch_counters

Metrics = Dict[str, torch.Tensor]
Generators = Tuple[Optional[torch.Generator], ...]


def _init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Adam's state for every parameter with a gradient, made by Adam's own
    lazy init (its _init_group), without an update: step 0 on the device,
    both moments zeros."""
    for group in optimizer.param_groups:
        optimizer._init_group(group, [], [], [], [], [], [])


def _on(a: torch.device, b: torch.device) -> bool:
    """Whether devices a and b are one (an index left out is device 0's)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class StepGraph:
    """The graph of one step object.  loss_fn(batch, generators, seams) ->
    (loss, metrics) is the step's eager loss: generators a tuple (one a
    member, None where a member draws nothing), seams a dict of the
    handed-in draws (None where drawn); `optimizers` the Adams whose step
    follows the backward, on `device`."""

    def __init__(self, loss_fn: Callable, optimizers: Sequence[torch.optim.Adam],
                 device: torch.device):
        self._loss_fn, self._optimizers = loss_fn, list(optimizers)
        self._params = [p for opt in self._optimizers
                        for group in opt.param_groups for p in group["params"]]
        self._device = torch.device(device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self._generators: Generators = ()
        self._inputs: List[Optional[torch.Tensor]] = []
        self._metrics: Metrics = {}
        self._grads: List[Optional[torch.Tensor]] = []
        self._launched: List[Tuple[Callable, int]] = []

    @staticmethod
    def _flatten(batch: Mapping, seams: Mapping) -> Tuple[list, pytree.TreeSpec, tuple]:
        """The call's tensors in a fixed order (the batch's leaves by name
        first), the structure, and the key a replay must match."""
        leaves, spec = pytree.tree_flatten(({k: batch[k] for k in sorted(batch)}, dict(seams)))
        leaves = [None if t is None else torch.as_tensor(t) for t in leaves]
        return leaves, spec, (spec, tuple(None if t is None else (tuple(t.shape), t.dtype)
                                          for t in leaves))

    def matches(self, key: tuple, generators: Generators) -> bool:
        """Whether a call of `key` (_flatten's) and `generators` replays the
        captured graph: the same shapes, dtypes and seams, and the very
        generators the graph draws from."""
        return (key == self._key and len(generators) == len(self._generators)
                and all(a is b for a, b in zip(generators, self._generators)))

    def stage(self, batch: Mapping, generators: Sequence[Optional[torch.Generator]],
              seams: Mapping) -> bool:
        """Copy the call's batch and seams into the graph's inputs, capturing
        the graph at the first call; False, with nothing done, where the call
        does not match the captured one."""
        generators = tuple(generators)
        if any(g is not None and not _on(g.device, self._device) for g in generators):
            return False  # draws made on another device, copied in: no graph holds a copy
        leaves, spec, key = self._flatten(batch, seams)
        if self._graph is None:
            self._capture(leaves, spec, key, generators, n_batch=len(batch))
            return True
        if not self.matches(key, generators):
            return False
        # one call: the host, which the prefetcher's worker contends for,
        # is what delays the launch
        torch._foreach_copy_([t for t in self._inputs if t is not None],
                             [t for t in leaves if t is not None])
        return True

    def _capture(self, leaves: list, spec: pytree.TreeSpec, key: tuple,
                 generators: Generators, n_batch: int) -> None:
        dev = self._device
        counters = list(launch_counters().values())
        before = [fn.launches for fn in counters]
        drawn = list({id(g): g for g in generators if g is not None}.values())
        with torch.cuda.device(dev):
            # the batch as the step reads it (f32), the seams as handed in
            self._inputs = [None if t is None else
                            torch.empty(t.shape, device=dev,
                                        dtype=torch.float32 if i < n_batch else t.dtype)
                            for i, t in enumerate(leaves)]
            for dst, src in zip(self._inputs, leaves):
                if dst is not None:
                    dst.copy_(src)
            batch, seams = pytree.tree_unflatten(self._inputs, spec)

            # warm-up: every lazy init (libraries, caches, autograd's) runs
            # outside the capture, on the stream the capture then uses, so
            # that no autograd node it leaves behind ties another stream in;
            # its draws are given back
            states = [g.get_state() for g in drawn]
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for opt in self._optimizers:
                    opt.zero_grad(set_to_none=True)
                self._loss_fn(batch, generators, seams)[0].backward()
            current.wait_stream(side)
            for g, state in zip(drawn, states):
                g.set_state(state)
            for opt in self._optimizers:
                _init_adam_state(opt)
                opt.zero_grad(set_to_none=True)
            # the warm-up's freed blocks back to the device, for the graph's
            # own pool to take: a large step does not fit twice
            torch.cuda.empty_cache()

            warmed = [fn.launches for fn in counters]
            graph = torch.cuda.CUDAGraph()
            for g in drawn:
                graph.register_generator_state(g)
            try:
                # thread_local: the prefetcher's worker keeps copying meanwhile
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    loss, metrics = self._loss_fn(batch, generators, seams)
                    loss.backward()
                    for opt in self._optimizers:
                        opt.step()
                    metrics = {k: v.detach() for k, v in metrics.items()}
            except RuntimeError as err:
                raise RuntimeError(
                    "the training step's CUDA graph could not be captured; an autograd graph "
                    "through its parameters held from before its first call (a loss kept "
                    "from an eager forward) is one cause") from err
            del loss
        self._launched = [(fn, fn.launches - n) for fn, n in zip(counters, warmed)
                          if fn.launches != n]
        for fn, n in zip(counters, before):
            fn.launches = n  # the warm-up and the capture are no step's
        self._graph, self._key, self._metrics = graph, key, metrics
        self._generators = generators
        self._grads = [p.grad for p in self._params]
        count("train.graph_capture")

    def replay(self) -> Metrics:
        """Run the captured step on the staged inputs; its metrics."""
        self._graph.replay()
        for fn, n in self._launched:
            fn.launches += n
        for p, g in zip(self._params, self._grads):
            if p.grad is not g:  # an eager step of the same object replaced it
                p.grad = g
        count("train.graph_replay")
        return {k: v.clone() for k, v in self._metrics.items()}
