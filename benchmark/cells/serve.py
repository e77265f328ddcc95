"""Closed-loop serving: the port's render_image, one view after another
along the mix's path, each ending in a synchronize; each view's compared
rays kept."""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import check, mixes
from benchmark.harness import Spec, Window, sync
from benchmark.trace import Tracer


class Cell:
    def __init__(self, port, spec: Spec, seeds: List[int], device, weights):
        self.spec, self.device = spec, device
        self.cam = mixes.camera(spec.traffic)
        self.model, self.fine, self.rc, self.args = port.build(spec.flags, weights, device)
        self.render, self.prime = port.view_renderer(self.model, self.fine, self.rc, self.args,
                                                     self.cam, device)
        self.views = mixes.Views(spec.traffic, seeds[3], seeds[4])
        self.kept: List = []
        n = self.cam["H"] * self.cam["W"]
        # render_image pads the last tile to a whole one
        self.rays_per_unit, self.tiles_per_view = n, -(-n // self.args.chunk)

    def warm(self) -> None:
        self.prime(self.views.pose(0))
        sync(self.device)

    def unit(self, tracer: Tracer, window: Window) -> None:
        i = len(self.kept)
        picks = torch.as_tensor(self.views.picks(), device=self.device)
        with tracer.span("bench.view"):
            maps = self.render(self.views.pose(i))
            kept = {k: maps[k].reshape(-1, *maps[k].shape[2:])[picks]
                    for k in ("rgb_map", "depth_map", "acc_map")}
            sync(self.device)
        self.kept.append((i, picks, kept))

    def close(self) -> None:
        del self.render, self.prime, self.model, self.fine

    def reference_maps(self, weights, matmul: str = "f32"):
        """Each kept view's index, and the reference's maps of its compared
        rays."""
        ref, cam = self.spec.reference, self.cam
        for i, picks, _ in self.kept:
            c2w = torch.as_tensor(self.views.pose(i), device=self.device)
            rays_o, rays_d = ref.pixel_rays(cam["H"], cam["W"], cam["focal"], c2w, picks)
            yield i, ref.render_test(weights, self.spec.flags, rays_o, rays_d, cam["near"],
                                     cam["far"], matmul)

    def numbers(self, weights) -> Dict[str, float]:
        worst = 0.0
        for (_, _, maps), (_, out) in zip(self.kept, self.reference_maps(weights)):
            worst = max(worst, check.maps_gap(maps, out, self.cam["far"]))
        return {"maps_gap": worst}
