"""The port's flagship entry (cfnerf_torch/entry.py) against
__graft_entry__.py's: _flagship built small on both sides, the JAX weights
converted into the port's model, entry()'s 256 example rays rendered in test
mode by JAX's make_render_rays and by the port's fn."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship as jax_flagship
from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
from cfnerf_tpu.render.renderer import make_render_rays as jax_make_render_rays
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.entry import N_RAYS, _flagship, entry, example_rays, make_fn
from tests.test_torch_common import to_np

# the golden gate of the port against JAX (chip_smoke.py's hier_serve rule)
RTOL = ATOL = 1e-4
SMALL = dict(k_samples=4, n_samples=16, depth=2, width=32)


@pytest.mark.parametrize("widths", [SMALL, dict(SMALL, depth=4, width=64)])
def test_flagship_render_matches_jax(widths):
    jmodel, jrc = jax_flagship(**widths)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 90), jnp.float32),
                         is_test=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    eps = jmodel.apply({"params": params}, method=JaxNeRFFlows._test_eps)

    def model_apply(p, x, *, is_test, rng):
        return jmodel.apply({"params": p}, x, is_test=is_test, rng=rng)

    rays = example_rays("cpu")
    jout = jax_make_render_rays(model_apply, jrc)(
        params, *(jnp.asarray(to_np(r)) for r in rays), None, is_test=True)

    model, rc = _flagship(**widths)
    model.load_state_dict(nerf_flows_state_dict_from_jax(params, tuple(np.asarray(e)
                                                                       for e in eps)))
    got = make_fn(rc)(model, *rays)
    for g, key in zip(got, ("rgb_map", "disp_map", "depth_map")):
        np.testing.assert_allclose(to_np(g), np.asarray(jout[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_entry_on_the_cpu_is_the_flagship():
    fn, args = entry(device="cpu")
    model = args[0]
    assert (model.net_depth, model.net_width, model.k_samples) == (8, 512, 32)
    rgb, disp, depth = fn(*args)
    assert rgb.shape == (N_RAYS, 3, 32) and disp.shape == depth.shape == (N_RAYS, 32)
    assert all(bool(t.isfinite().all()) for t in (rgb, disp, depth))


def test_entry_needs_a_card_or_device_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
