"""The benchmark's one door into the program under test, cfnerf_torch.

Everything the harness asks of the port goes through here: its kernels'
build, its parser and model factory, the training step and its samplers and
prefetcher, the renderer, and its launch counters.  No other file of the
benchmark imports the port.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from cfnerf_torch.data.prefetch import BatchPrefetcher
from cfnerf_torch.data.sampler import (
    DepthRayBatcher,
    RayBatcher,
    SingleImageSampler,
    precompute_depth_rays,
    precompute_rays,
)
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.ops.kernels import _build, flow_stack, render_core, trunk
from cfnerf_torch.ops.rays import get_rays
from cfnerf_torch.render.renderer import make_render_rays, prepare_rays, render_image
from cfnerf_torch.train.step import TrainConfig, make_train_step
from cfnerf_torch.utils.config import parse_args

# the port's launch counters, by the name the result line gives them
COUNTERS = {
    "render_core_fwd": render_core.fused_flow_composite,
    "render_core_bwd": render_core.fused_flow_composite_bwd,
    "flow_stack_fwd": flow_stack.fused_flow_stack,
    "flow_stack_bwd": flow_stack.fused_flow_stack_bwd,
    "trunk_fwd": trunk.trunk_encode,
    "trunk_bwd": trunk.trunk_encode_bwd,
}


def build_kernels() -> None:
    """Compile the port's CUDA kernels into its cache inside the checkout
    (build/kernels/), or find them there."""
    _build.build()


def launches() -> Dict[str, int]:
    return {name: int(fn.launches) for name, fn in COUNTERS.items()}


def argv(flags: Dict) -> List[str]:
    """The configuration's flags as the port's command line."""
    out = []
    for key, value in flags.items():
        if value is True:
            out.append(f"--{key}")
        elif value is not False:
            out += [f"--{key}", str(value)]
    return out


def build(flags: Dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
    """The configuration's nets through the port's parser and factory, with
    the given weights loaded (every parameter and test-mode draw, strictly).
    Returns (model, model_fine or None, render config, args)."""
    args = parse_args(argv(flags))
    model, model_fine, rc = build_model(args, device=device)
    for name, net in (("coarse", model), ("fine", model_fine)):
        if net is not None:
            net.load_state_dict(weights[name], strict=True)
    return model, model_fine, rc, args


def train_step(model, model_fine, rc, args, scene: Dict):
    """make_train_step with the configuration's loss and schedule."""
    cfg = TrainConfig(H=scene["H"], W=scene["W"], focal=scene["focal"], ndc=not args.no_ndc,
                      near=scene["near"], far=scene["far"], k_samples=args.K_samples,
                      lrate=args.lrate, lrate_decay=args.lrate_decay, beta1=args.beta1,
                      colmap_depth=args.colmap_depth, depth_lambda=args.depth_lambda)
    step, optimizer = make_train_step(model, rc, cfg, model_fine=model_fine)
    return step, optimizer


def call_step(step, item: Dict) -> Dict[str, torch.Tensor]:
    """One training step on a fed item: its batch, with the benchmark's
    draws handed in through the step's keywords of the same names (z_vals,
    eps, and with a fine pass pdf_u and eps_fine), so that the step draws
    nothing from a generator of its own."""
    return step(item["batch"], None, **item["draws"])


def samplers(args, scene: Dict, seed: int, first_step: int) -> Callable[[int], Dict]:
    """next_batch(step): the port's samplers over the scene as the
    configuration's flags pick them: --no_batching one image's N_rand rays
    a step (SingleImageSampler, past its precrop from first_step on), else
    RayBatcher's shuffled epochs of every view's rays, and with
    --colmap_depth DepthRayBatcher's 128 depth rays beside them."""
    i_train = list(range(len(scene["images"])))
    H, W, focal = scene["H"], scene["W"], scene["focal"]
    if args.no_batching:
        rays = SingleImageSampler(scene["images"], scene["poses"], focal, i_train, args.N_rand,
                                  precrop_iters=args.precrop_iters,
                                  precrop_frac=args.precrop_frac, seed=seed)
        take = lambda step: rays.next(first_step + step)  # noqa: E731
    else:
        rays = RayBatcher(precompute_rays(scene["images"], scene["poses"], focal, i_train,
                                          seed=seed), args.N_rand, seed=seed)
        take = lambda step: rays.next()  # noqa: E731
    depth = None
    if args.colmap_depth:
        depth = DepthRayBatcher(precompute_depth_rays(scene["depth_gts"], scene["poses"], H, W,
                                                      focal, i_train, seed=seed), seed=seed)

    def next_batch(step: int) -> Dict[str, np.ndarray]:
        batch = take(step)
        if depth is not None:
            batch.update(depth.next())
            batch.pop("ray_weights")  # loaded but unused by the loss
        return batch

    return next_batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch on the device as the port's loop moves it: pinned, then
    copied without blocking (on the prefetcher's stream)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            dev, non_blocking=True) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def prefetcher(make_item: Callable[[int], Dict], device) -> BatchPrefetcher:
    """The port's BatchPrefetcher: make_item(step) runs on its worker
    thread, under its own stream on the card."""
    return BatchPrefetcher(make_item, 0, device=device)


def view_renderer(model, model_fine, rc, args, scene: Dict, device):
    """render(c2w) -> the view's maps through render_image at --chunk rays a
    tile, test mode (K draws a pixel); and warm(c2w), one tile of the view
    through the same renderer: the tile's shapes, the only ones a view
    launches (render_image pads the last tile to a whole one)."""
    for net in (model, model_fine):
        if net is not None:
            net.eval()
    render_rays = make_render_rays(model, rc, model_fine=model_fine)
    view = dict(H=scene["H"], W=scene["W"], focal=scene["focal"], ndc=not args.no_ndc,
                use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"],
                tile=args.chunk, device=device)

    def render(c2w: np.ndarray) -> Dict[str, torch.Tensor]:
        return render_image(render_rays, c2w, **view)

    def warm(c2w: np.ndarray) -> None:
        with torch.inference_mode():
            pose = torch.as_tensor(c2w, dtype=torch.float32, device=device)
            rays = prepare_rays(*get_rays(scene["H"], scene["W"], scene["focal"], pose),
                                H=scene["H"], W=scene["W"], focal=scene["focal"],
                                ndc=not args.no_ndc, use_viewdirs=args.use_viewdirs,
                                near=scene["near"], far=scene["far"])
            render_rays(*(None if t is None else t[:args.chunk] for t in rays), None,
                        is_test=True)

    return render, warm
