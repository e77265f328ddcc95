"""Shared parity helpers for the PyTorch port's tests, plus the tests of the
weight conversion itself.

Inputs are made with numpy from a seed and handed to both frameworks; JAX
runs on the CPU, the port runs its plain PyTorch versions on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.models.nerf_flows import NeRFFlows


@dataclasses.dataclass(frozen=True)
class Tiny:
    """A NeRFFlows configuration at test size."""

    depth: int = 4
    width: int = 64
    k: int = 8
    flows: int = 2
    h_alpha: int = 16
    h_rgb: int = 16
    use_viewdirs: bool = True

    @property
    def views_ch(self):
        return 27 if self.use_viewdirs else 0


FLAGSHIP = Tiny(depth=8, width=512, k=32, flows=4, h_alpha=64, h_rgb=64)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_nerf_flows(cfg: Tiny = Tiny(), seed: int = 0, flow_impl: str = "xla",
                   trunk_impl: str = "xla"):
    """(JAX model, params as nested numpy dicts, JAX test eps).  The base
    parameters are moved off their 0/1 init so they are exercised.
    flow_impl="interpret" runs the model's flow stacks through the Pallas
    kernel's interpreter, as flow_impl="pallas" runs them on a TPU;
    trunk_impl="interpret" its trunk likewise."""
    model = JaxNeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63,
        input_ch_views=cfg.views_ch, skips=(cfg.depth // 2,),
        h_alpha_size=cfg.h_alpha, h_rgb_size=cfg.h_rgb, n_flows=cfg.flows,
        k_samples=cfg.k, use_viewdirs=cfg.use_viewdirs, type_flows="triangular",
        flow_impl=flow_impl, trunk_impl=trunk_impl,
    )
    x = jnp.zeros((2, 63 + cfg.views_ch), jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), x, is_test=True)["params"]
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(params))
    rng = np.random.RandomState(seed + 100)
    params["alpha_mean"] = (rng.randn(1) * 0.3).astype(np.float32)
    params["alpha_std"] = (0.5 + rng.rand(1)).astype(np.float32)
    params["rgb_mean"] = (rng.randn(3) * 0.3).astype(np.float32)
    params["rgb_std"] = (0.5 + rng.rand(3)).astype(np.float32)
    eps = model.apply({"params": params}, method=JaxNeRFFlows._test_eps)
    return model, params, tuple(np.asarray(e) for e in eps)


def port_nerf_flows(cfg: Tiny, params, test_eps, trunk_impl: str = "xla") -> NeRFFlows:
    model = NeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63,
        input_ch_views=cfg.views_ch, skips=(cfg.depth // 2,),
        h_alpha_size=cfg.h_alpha, h_rgb_size=cfg.h_rgb, n_flows=cfg.flows,
        k_samples=cfg.k, use_viewdirs=cfg.use_viewdirs, trunk_impl=trunk_impl,
    )
    model.load_state_dict(nerf_flows_state_dict_from_jax(params, test_eps))
    return model


def render_core_inputs(R, S, K, F, seed=0, saturate=False):
    """Numpy inputs of the render core (as tests/test_render_core.py makes
    them): dict of the eight flow arrays, z_vals (R, S), rays_d (R, 3)."""
    rng = np.random.RandomState(seed)
    B, sc = R * S, 0.5
    args = dict(
        z0_a=rng.randn(K, 1) * sc,
        r1_a=rng.randn(B, 1, 1, F) * sc,
        r2_a=rng.randn(B, 1, 1, F) * sc,
        b_a=rng.randn(B, 1, F) * sc,
        z0_r=rng.randn(K, 3) * sc,
        r1_r=np.triu(rng.randn(B, F, 3, 3) * sc).transpose(0, 2, 3, 1),
        r2_r=np.triu(rng.randn(B, F, 3, 3) * sc).transpose(0, 2, 3, 1),
        b_r=rng.randn(B, 3, F) * sc,
    )
    if saturate:
        # drive some densities to alpha == 1 (transmittance kill zone)
        args["b_a"][: B // 7, 0, :] = 8.0
    args = {k: np.ascontiguousarray(v, np.float32) for k, v in args.items()}
    z_vals = (np.sort(rng.rand(R, S), -1) * 3.5 + 0.5).astype(np.float32)
    rays_d = rng.randn(R, 3).astype(np.float32)
    return args, z_vals, rays_d


def dists_np(z_vals, rays_d):
    d = np.concatenate([z_vals[:, 1:] - z_vals[:, :-1],
                        np.full_like(z_vals[:, :1], 10.0)], -1)
    return (d * np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------- #
# the conversion itself
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_state_dict_covers_every_parameter(use_viewdirs):
    cfg = Tiny(use_viewdirs=use_viewdirs)
    _, params, eps = jax_nerf_flows(cfg)
    sd = nerf_flows_state_dict_from_jax(params, eps)
    model = port_nerf_flows(cfg, params, eps)  # strict load: no key missing
    assert set(sd) == set(model.state_dict())
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port


def test_dense_layers_transpose_and_skip_order():
    cfg = Tiny()
    _, params, eps = jax_nerf_flows(cfg)
    model = port_nerf_flows(cfg, params, eps)
    skip_layer = model.pts_linears[cfg.depth // 2 + 1]
    assert tuple(skip_layer.weight.shape) == (cfg.width, 63 + cfg.width)
    np.testing.assert_array_equal(
        to_np(skip_layer.weight),
        params[f"pts_linear_{cfg.depth // 2 + 1}"]["kernel"].T,
    )
    np.testing.assert_array_equal(to_np(model.test_eps_r), eps[1])
    assert np.all(eps[0][-1] == 0) and np.all(eps[1][-1] == 0)


def test_without_test_eps_keeps_model_buffers():
    cfg = Tiny()
    _, params, _ = jax_nerf_flows(cfg)
    sd = nerf_flows_state_dict_from_jax(params)
    assert "test_eps_a" not in sd and "test_eps_r" not in sd
    fresh = NeRFFlows(net_depth=4, net_width=64, skips=(2,), h_alpha_size=16,
                      h_rgb_size=16, n_flows=2, k_samples=8)
    before = fresh.test_eps_a.clone()
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert set(missing) == {"test_eps_a", "test_eps_r"} and not unexpected
    torch.testing.assert_close(fresh.test_eps_a, before)
    assert float(fresh.test_eps_a[-1]) == 0.0
