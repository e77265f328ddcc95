"""The slice end to end: the port's render_image against cfnerf_tpu's on
converted weights and JAX's own test eps, plus the golden file that lets
chip_smoke.py hold the card's kernel path against JAX numbers.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_render
(test_golden_is_current fails while the committed file is stale).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.render import renderer as jrender
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_image,
)
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_golden.npz"
CFG = Tiny(depth=4, width=64, k=8, flows=2, h_alpha=16, h_rgb=16)
VIEW = dict(H=12, W=12, focal=14.0, ndc=False, use_viewdirs=True, near=2.0, far=6.0)
N_SAMPLES = 32
MAPS = ("rgb_map", "depth_map", "acc_map", "disp_map")


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.3, -0.2, 4.0]
    return c2w


def _jax_render(params, tile=64):
    """cfnerf_tpu's unfused test-mode render (the fused TPU kernel cannot
    take R=64 rays per tile)."""
    jm, _, _ = jax_nerf_flows(CFG)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=False, use_viewdirs=True,
                              white_bkgd=True)

    def apply(p, x, *, is_test, rng):
        return jm.apply({"params": p}, x, is_test=is_test, rng=rng)

    out = jrender.render_image(jrender.make_render_rays(apply, rc), params,
                               jnp.asarray(_c2w()), tile=tile, **VIEW)
    return {k: np.asarray(out[k]) for k in MAPS}


def _port_render(model, fused, tile=64):
    rc = RenderConfig(n_samples=N_SAMPLES, perturb=False, use_viewdirs=True,
                      white_bkgd=True, fused="on" if fused else "off")
    out = render_image(make_render_rays(model, rc), _c2w(),
                       tile=tile, device="cpu", **VIEW)
    return {k: to_np(out[k]) for k in MAPS}


def _assert_maps_close(out, ref, rtol=2e-5, atol=2e-5):
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=atol, err_msg=k)
    mask = ref["acc_map"] > 1e-3  # disparity is 1/(depth/acc): meaningful where acc > 0
    np.testing.assert_allclose(out["disp_map"][mask], ref["disp_map"][mask],
                               rtol=1e-4, atol=1e-5, err_msg="disp_map")


@pytest.mark.parametrize("fused", [True, False], ids=["render_core", "unfused"])
def test_render_image_matches_jax(fused):
    # 144 rays in tiles of 64: the last tile is padded with the last ray
    _, params, test_eps = jax_nerf_flows(CFG)
    model = port_nerf_flows(CFG, params, test_eps)
    ref = _jax_render(params)
    out = _port_render(model, fused)
    assert out["rgb_map"].shape == (12, 12, 3, CFG.k)
    assert out["depth_map"].shape == (12, 12, CFG.k)
    _assert_maps_close(out, ref)


def test_tile_size_does_not_change_the_image():
    _, params, test_eps = jax_nerf_flows(CFG)
    model = port_nerf_flows(CFG, params, test_eps)
    a, b = _port_render(model, True, tile=64), _port_render(model, True, tile=144)
    for k in MAPS:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_render_image_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_image(lambda *a, **k: {}, _c2w(), tile=64, **VIEW)


@pytest.mark.parametrize("ndc", [False, True])
def test_prepare_rays_matches(ndc):
    rng = np.random.RandomState(0)
    ro = (rng.randn(6, 5, 3) * 0.1).astype(np.float32)
    rd = np.concatenate([rng.randn(6, 5, 2) * 0.2, -np.ones((6, 5, 1))], -1).astype(np.float32)
    kw = dict(H=6, W=5, focal=7.0, ndc=ndc, use_viewdirs=True, near=0.0, far=1.0)
    j = jrender.prepare_rays(jnp.asarray(ro), jnp.asarray(rd), **kw)
    t = prepare_rays(torch.as_tensor(ro), torch.as_tensor(rd), **kw)
    for a, b in zip(t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_train_mode_fused_and_unfused_agree_on_one_generator():
    """Training-mode rays: stratified jitter and fresh shared-K eps from one
    torch.Generator seed give the same composite through both paths; the
    unfused path also returns the per-sample weights."""
    _, params, test_eps = jax_nerf_flows(CFG)
    model = port_nerf_flows(CFG, params, test_eps)
    rc = RenderConfig(n_samples=N_SAMPLES, perturb=True, use_viewdirs=True)
    rng = np.random.RandomState(2)
    rays_o = torch.as_tensor(rng.randn(20, 3).astype(np.float32))
    rays_d = torch.as_tensor(np.concatenate([rng.randn(20, 2) * 0.1, -np.ones((20, 1))],
                                            -1).astype(np.float32))
    vd = rays_d / rays_d.norm(dim=-1, keepdim=True)
    near, far = torch.full((20, 1), 0.5), torch.full((20, 1), 4.0)
    outs = [make_render_rays(model, dataclasses.replace(rc, fused=f))(
        rays_o, rays_d, vd, near, far, torch.Generator().manual_seed(5), is_test=False)
        for f in ("on", "off")]
    for k in ("rgb_map", "depth_map", "acc_map", "disp_map", "loss_entropy"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=2e-5, atol=2e-5)
    assert "weights" in outs[1] and tuple(outs[1]["weights"].shape) == (20, N_SAMPLES, CFG.k)
    assert torch.isfinite(outs[0]["loss_entropy"])


@pytest.mark.parametrize("over", [dict(n_importance=8),
                                  dict(apply_noise=True, raw_noise_std=1.0)],
                         ids=["hierarchical", "applied_noise"])
def test_hierarchical_and_applied_noise_take_the_unfused_path(over, monkeypatch):
    """As in the JAX renderer (renderer.py:188-192): the render core is not
    called, the model's unfused forward (its flow stacks in the flow-stack
    kernels on the card) is, and train mode returns the weights."""
    _, params, test_eps = jax_nerf_flows(CFG)
    model = port_nerf_flows(CFG, params, test_eps)
    monkeypatch.setattr(model, "forward_composited",
                        lambda *a, **k: pytest.fail("the render core was called"))
    rng = np.random.RandomState(4)
    rays_o = torch.as_tensor((rng.randn(6, 3) * 0.1 + [0, 0, 4]).astype(np.float32))
    rays_d = torch.as_tensor(np.concatenate([rng.randn(6, 2) * 0.1, -np.ones((6, 1))],
                                            -1).astype(np.float32))
    vd = rays_d / rays_d.norm(dim=-1, keepdim=True)
    near, far = torch.full((6, 1), 2.0), torch.full((6, 1), 6.0)
    out = make_render_rays(model, RenderConfig(n_samples=N_SAMPLES, **over))(
        rays_o, rays_d, vd, near, far, torch.Generator().manual_seed(1), is_test=False)
    S = N_SAMPLES + over.get("n_importance", 0)
    assert tuple(out["weights"].shape) == (6, S, CFG.k)
    assert ("rgb0" in out) == ("n_importance" in over)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


# ---------------------------------------------------------------------- #
# golden for the card: JAX's render of a tiny model, with its weights
# ---------------------------------------------------------------------- #


def golden_arrays():
    _, params, test_eps = jax_nerf_flows(CFG)
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays["test_eps_a"], arrays["test_eps_r"] = test_eps
    arrays["c2w"] = _c2w()
    arrays["config"] = np.array([CFG.depth, CFG.width, CFG.k, CFG.flows, CFG.h_alpha,
                                 CFG.h_rgb, N_SAMPLES, VIEW["H"], VIEW["W"]], np.int64)
    arrays["view"] = np.array([VIEW["focal"], VIEW["near"], VIEW["far"]], np.float32)
    arrays.update({f"jax/{k}": v for k, v in _jax_render(params).items()})
    return arrays


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def save_golden():
    np.savez_compressed(GOLDEN, **golden_arrays())


def test_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_render"
    assert GOLDEN.stat().st_size < 1 << 20
    fresh = golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith("jax/"):
                # XLA's CPU reductions are deterministic on one build; the
                # margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-7,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_golden_renders_through_the_port():
    """What chip_smoke.py does on the card, here through the plain version."""
    from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
    from cfnerf_torch.models.nerf_flows import NeRFFlows

    with np.load(GOLDEN) as g:
        D, W, K, F, ha, hr, n, H, Wd = (int(v) for v in g["config"])
        params = {}
        for k in g.files:
            if k.startswith("p/"):
                node = params
                *parents, leaf = k[2:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = g[k]
        model = NeRFFlows(net_depth=D, net_width=W, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            params, (g["test_eps_a"], g["test_eps_r"])))
        out = _port_render(model, True)
        _assert_maps_close(out, {k: g[f"jax/{k}"] for k in MAPS})


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
