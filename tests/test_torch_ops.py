"""The port's ops against cfnerf_tpu's on the same numpy inputs.

Tolerances: rtol/atol 1e-6 where both sides do the same f32 arithmetic;
looser (stated per test) where a transcendental of a large argument or a
different reduction order enters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops import compositing as jcomp
from cfnerf_tpu.ops import embed as jembed
from cfnerf_tpu.ops import metrics as jmetrics
from cfnerf_tpu.ops import rays as jrays
from cfnerf_tpu.ops import sampling as jsampling
from cfnerf_torch.ops import compositing, embed, metrics, rays, sampling
from tests.test_torch_common import to_np

T = torch.as_tensor


@pytest.mark.parametrize("multires,i_embed", [(10, 0), (4, 0), (10, -1)])
def test_embedder_matches(multires, i_embed):
    x = np.random.RandomState(0).uniform(-2, 2, (50, 3)).astype(np.float32)
    jemb, jdim = jembed.get_embedder(multires, i_embed)
    temb, tdim = embed.get_embedder(multires, i_embed)
    assert jdim == tdim == temb.out_dim
    # sin/cos of arguments up to 2 * 2^9 = 1024: f32 libm differences ~1e-4
    np.testing.assert_allclose(to_np(temb(T(x))), np.asarray(jemb(jnp.asarray(x))),
                               rtol=1e-6, atol=2e-4)


def test_positional_encoding_feature_order():
    x = np.array([[0.1, 0.2, 0.3]], np.float32)
    out = to_np(embed.positional_encoding(T(x), 2))
    ref = np.concatenate([x, np.sin(x), np.cos(x), np.sin(2 * x), np.cos(2 * x)], -1)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_get_rays_matches():
    c2w = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    jo, jd = jrays.get_rays(7, 9, 11.5, jnp.asarray(c2w))
    to, td = rays.get_rays(7, 9, 11.5, T(c2w))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_ndc_rays_matches():
    rng = np.random.RandomState(2)
    ro = (rng.randn(40, 3) * 0.1).astype(np.float32)
    rd = np.concatenate([rng.randn(40, 2) * 0.2, -np.ones((40, 1))], -1).astype(np.float32)
    jo, jd = jrays.ndc_rays(16, 20, 15.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    to, td = rays.ndc_rays(16, 20, 15.0, 1.0, T(ro), T(rd))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,lindisp,uniform", [
    (128, False, False), (64, False, False), (128, True, False), (20, False, True),
])
def test_sample_z_vals_matches(n, lindisp, uniform):
    rng = np.random.RandomState(3)
    near = (1.0 + rng.rand(6, 1)).astype(np.float32)
    far = (near + 2.0 + rng.rand(6, 1)).astype(np.float32)
    j = jsampling.sample_z_vals(jnp.asarray(near), jnp.asarray(far), n,
                                lindisp=lindisp, uniform=uniform)
    t = sampling.sample_z_vals(T(near), T(far), n, lindisp=lindisp, uniform=uniform)
    assert tuple(t.shape) == (6, n)
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_cf_nerf_schedule_is_96_plus_32():
    t = to_np(sampling.cf_nerf_t_vals(128))
    assert (t < 0.5).sum() == 96 and (t >= 0.5).sum() == 32
    np.testing.assert_array_equal(t, np.asarray(jsampling.cf_nerf_t_vals(128)))


def test_stratified_perturb_with_injected_uniforms():
    z = np.sort(np.random.RandomState(4).rand(5, 17), -1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    j = jsampling.stratified_perturb(jnp.asarray(z), key)
    u = np.array(jax.random.uniform(key, z.shape, dtype=jnp.float32))
    t = sampling.stratified_perturb(T(z), t_rand=T(u))
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_stratified_perturb_generator_stays_in_bins():
    z = torch.linspace(2.0, 6.0, 32).expand(3, 32)
    g = torch.Generator().manual_seed(0)
    out = sampling.stratified_perturb(z, g)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    assert torch.all(out[:, 1:] >= mids - 1e-6) and torch.all(out[:, :-1] <= mids + 1e-6)
    again = sampling.stratified_perturb(z, torch.Generator().manual_seed(0))
    torch.testing.assert_close(out, again, rtol=0, atol=0)


@pytest.mark.parametrize("white_bkgd,saturate", [(False, False), (True, True)])
def test_raw2outputs_matches(white_bkgd, saturate):
    rng = np.random.RandomState(5)
    R, S, K = 16, 24, 6
    raw = rng.randn(R, S, K, 4).astype(np.float32)
    if saturate:
        raw[:, :5, :, 3] = 40.0  # alpha == 1 exactly
    z = (np.sort(rng.rand(R, S), -1) * 4 + 2).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    j = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                          white_bkgd=white_bkgd, raw_noise_std=1.0)
    t = compositing.raw2outputs(T(raw), T(z), T(rd), white_bkgd=white_bkgd,
                                raw_noise_std=1.0)
    for name, a, b in zip(("rgb", "disp", "acc", "weights", "depth"), t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_raw2outputs_applied_noise_matches_jax():
    """JAX's noise, drawn from its key (compositing.py:99-100), injected."""
    rng = np.random.RandomState(8)
    R, S, K = 6, 10, 4
    raw = rng.randn(R, S, K, 4).astype(np.float32)
    z = (np.sort(rng.rand(R, S), -1) * 4 + 2).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                          raw_noise_std=0.5, rng=key, apply_noise=True)
    noise = T(np.array(jax.random.normal(key, (R, S, K))))
    t = compositing.raw2outputs(T(raw), T(z), T(rd), raw_noise_std=0.5,
                                apply_noise=True, noise=noise)
    quiet = compositing.raw2outputs(T(raw), T(z), T(rd), raw_noise_std=0.5)
    for name, a, b in zip(("rgb", "disp", "acc", "weights", "depth"), t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert float((t[3] - quiet[3]).abs().max()) > 1e-3  # the noise was applied


def test_softplus_has_no_threshold_cut():
    x = np.array([-50.0, -3.0, 0.0, 3.0, 19.0, 21.0, 80.0], np.float32)
    np.testing.assert_allclose(to_np(compositing.softplus(T(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_composite_grad_finite_at_saturation():
    alpha = torch.ones(2, 5, 3, requires_grad=True)
    compositing.composite_weights(alpha).sum().backward()
    assert torch.all(torch.isfinite(alpha.grad))


def test_std_over_k_map_convention():
    x = np.random.RandomState(6).rand(4, 5, 3, 8).astype(np.float32)
    np.testing.assert_allclose(to_np(metrics.std_over_k(T(x))), jmetrics.std_over_k(x),
                               rtol=1e-6, atol=1e-6)
    assert float(metrics.std_over_k(torch.ones(3, 1)).abs().max()) == 0.0


def test_mse_psnr_match():
    rng = np.random.RandomState(7)
    a, b = rng.rand(10, 3).astype(np.float32), rng.rand(10, 3).astype(np.float32)
    jm = jmetrics.img2mse(jnp.asarray(a), jnp.asarray(b))
    tm = metrics.img2mse(T(a), T(b))
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-6)
    np.testing.assert_allclose(float(metrics.mse2psnr(tm)),
                               float(jmetrics.mse2psnr(jm)), rtol=1e-6)
