"""Entry point of the flagship forward; counterpart of __graft_entry__.py's
_flagship and entry().

entry() returns (fn, example_args): fn(*example_args) renders a 256-ray
batch through the flagship model (the reference's headline configuration:
D=8, W=512, N=128 samples a ray, K=32 draws, 4 triangular Sylvester flows,
h=64) in test mode (K-sample inference) and returns (rgb_map (R, 3, K),
disp_map (R, K), depth_map (R, K)).  The model is the first example
argument, as the params are JAX's; its weights are init_params' from seed
0.  On the CUDA device unless entry(device="cpu"); the same seed gives the
same weights on both.  The multi-device dry run (JAX's dryrun_multichip)
comes with slice 8c.
"""
from __future__ import annotations

import torch

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
