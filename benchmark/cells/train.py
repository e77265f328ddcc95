"""Closed-loop training: the port's step on batches from its samplers
through its prefetcher, the family's draws handed in beside them; one step
after another, each ending in a synchronize."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import check, mixes
from benchmark.harness import Spec, Window, clone, sync
from benchmark.trace import Tracer


class Cell:
    def __init__(self, port, spec: Spec, seeds: List[int], device, weights):
        self.port, self.spec, self.device = port, spec, device
        t = spec.traffic
        t0 = time.perf_counter()
        self.scene = mixes.make_scene(t, seeds[0])
        t1 = time.perf_counter()
        self.model, self.fine, self.rc, self.args = port.build(spec.flags, weights, device)
        t2 = time.perf_counter()
        self.step, self.optimizer = port.train_step(self.model, self.fine, self.rc, self.args,
                                                    self.scene)
        t3 = time.perf_counter()
        next_batch = port.samplers(self.args, self.scene, seeds[5], t["first_step"])
        self.phases = {"scene": t1 - t0, "nets": t2 - t1, "step": t3 - t2,
                       "samplers": time.perf_counter() - t3}
        draws = spec.reference.StepDraws(spec.flags, t["camera"], seeds[2], device)

        def make_item(step: int) -> Dict:
            batch = port.to_device(next_batch(step), device)
            n_rays = batch["rays_o"].shape[0] + (batch["depth_rays_o"].shape[0]
                                                 if "depth_rays_o" in batch else 0)
            return {"batch": batch, "draws": draws(n_rays)}

        self.feed = port.prefetcher(make_item, device)
        self.checked: List = []
        self.rays_per_unit, self.tiles_per_view = 0, 0

    def params(self) -> Dict[str, torch.nn.Parameter]:
        out = {f"coarse/{k}": p for k, p in self.model.named_parameters()}
        if self.fine is not None:
            out.update({f"fine/{k}": p for k, p in self.fine.named_parameters()})
        return out

    def warm(self) -> None:
        """The first steps, through the window's own call and feed: the
        warm-up of every shape, and what the check replays."""
        params = self.params()
        start = {k: p.detach().clone() for k, p in params.items()}
        self.losses = []
        for i in range(self.spec.traffic["checked_steps"]):
            _, item = self.feed.next()
            self.checked.append(clone(item))
            metrics = self.port.call_step(self.step, item)
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                state = self.optimizer.state
                self.first_moment = {k: (state[p]["exp_avg"].clone() if p in state
                                         else torch.zeros_like(p)) for k, p in params.items()}
        self.change = {k: p.detach() - start[k] for k, p in params.items()}
        sync(self.device)

    def unit(self, tracer: Tracer, window: Window) -> None:
        t0 = time.perf_counter()
        with tracer.span("bench.batch_wait"):
            _, item = self.feed.next()
        t1 = time.perf_counter()
        with tracer.span("bench.step"):
            self.port.call_step(self.step, item)
            sync(self.device)
        window.waits.append(t1 - t0)
        self.rays_per_unit = int(item["draws"]["z_vals"].shape[0])

    def close(self) -> None:
        self.feed.close()
        del self.step, self.optimizer, self.model, self.fine, self.feed

    def numbers(self, weights) -> Dict[str, float]:
        cam = mixes.camera(self.spec.traffic)
        losses, grads, change = self.spec.reference.train_steps(
            weights, self.spec.flags, [(c["batch"], c["draws"]) for c in self.checked],
            cam["near"], cam["far"])
        return check.train_numbers(self.losses, self.first_moment, self.change,
                                   losses, grads, change)
