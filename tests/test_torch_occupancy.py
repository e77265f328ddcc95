"""Proposal-placed sampling: cfnerf_torch/ops/occupancy.py against
cfnerf_tpu/ops/occupancy.py on the same numpy inputs.

Tolerances, and why:
  * aabb, grid coordinates, the bake, the max pool and the lookup are the
    same f32 operations in the same order: bitwise equal;
  * placement sums its prefixes by cumsum where JAX multiplies by triangular
    ones matrices (Precision.HIGHEST): f32 sums in another order, a few ulp
    of each prefix, so depths agree to atol 2e-5 (~4 ulp of the far plane)
    wherever the floor keeps every bin's pdf up.  At floor 0 an empty bin's
    pdf is ~1e-8, below one ulp of a cdf near 1, so where a u meets the cdf
    at a run of empty bins (u = 1 behind the slab) the inverse may land at
    either end of that run: a sample past atol 2e-5 must differ from JAX's
    only across bins whose pdf is below 1e-6 (the CDF is flat there, both
    are inverses of it);
  * the proposal's hidden layers are bf16 products: PyTorch's and XLA's CPU
    products round the same f32 sums, which agree here bit for bit (atol
    1e-6 on its output leaves room for one f32 ulp of the last layer);
  * distillation: 8 Adam steps through bf16 hidden layers, whose gradients
    round apart now and then; Adam's normalised update turns a gradient
    near 0 into a step of up to lr either way, so each leaf's update (after
    minus init) is held by relative RMS <= 1e-2 and cosine >= 0.9999
    against JAX's (measured <= 3.0e-3 / >= 0.999995), the last loss to
    rtol 2e-4 (measured 3.5e-5);
  * renders through placed depths: the render tolerances of
    tests/test_torch_render.py (rtol = atol = 2e-5).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops import occupancy as jocc
from cfnerf_tpu.render import renderer as jrender
from cfnerf_torch.convert import proposal_state_dict_from_jax
from cfnerf_torch.ops import occupancy as tocc
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np

T = torch.as_tensor
CFG = Tiny(depth=2, width=32, k=4, flows=2, h_alpha=16, h_rgb=16)
Z_ATOL = 2e-5
MAP_TOL = dict(rtol=2e-5, atol=2e-5)
SLAB_LO, SLAB_HI = np.array([-1.0, -1.0, 0.0], np.float32), np.array([1.0, 1.0, 4.0], np.float32)


def _rays(R=16, seed=0):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = np.concatenate([rng.randn(R, 2) * 0.05, np.ones((R, 1))], -1).astype(np.float32)
    return ro, rd


def _slab_rays(R=32):
    """Straight +z rays through the slab scene of tests/test_occupancy.py."""
    ro = np.zeros((R, 3), np.float32)
    ro[:, 0] = np.linspace(-0.3, 0.3, R)
    rd = np.zeros((R, 3), np.float32)
    rd[:, 2] = 1.0
    return ro, rd


def _grid(kind):
    grid = np.zeros((64, 64, 64), np.float32)
    if kind == "slab":
        grid[:, :, 32:40] = 10.0  # z in [2.0, 2.5)
    return grid


def _assert_z_close(z, ref, pdf, near, bin_width):
    """Depths within Z_ATOL, or apart only across bins of pdf < 1e-6."""
    for r, i in zip(*np.nonzero(np.abs(z - ref) > Z_ATOL)):
        a, b = sorted((float(z[r, i]), float(ref[r, i])))
        first = int((a + Z_ATOL - near) // bin_width)
        last = int((b - Z_ATOL - near) // bin_width)
        assert np.all(pdf[r, first:last + 1] < 1e-6), (r, i, a, b)


def _pdf_np(sigma, z_edges, floor):
    """The placement pdf in float64 (cfnerf_tpu/ops/occupancy.py:167-176)."""
    tau = np.maximum(sigma, 0) * np.diff(z_edges, axis=-1)
    w = np.exp(-(np.cumsum(tau, -1) - tau)) * (1 - np.exp(-tau)) + (floor + 1e-6) / tau.shape[-1]
    return w / w.sum(-1, keepdims=True)


# ---------------------------------------------------------------------- #
# geometry, bake, lookup
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("pad", [0.05, 0.0])
def test_aabb_from_rays_matches(pad):
    ro, rd = _rays()
    near, far = np.full((16, 1), 0.5, np.float32), np.full((16, 1), 4.0, np.float32)
    jlo, jhi = jocc.aabb_from_rays(ro, rd, near, far, pad=pad)
    tlo, thi = tocc.aabb_from_rays(T(ro), T(rd), T(near), T(far), pad=pad)
    np.testing.assert_array_equal(to_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(to_np(thi), np.asarray(jhi))
    # scalar near / far broadcast as JAX's do
    jlo, _ = jocc.aabb_from_rays(ro, rd, 0.5, 4.0, pad=pad)
    tlo, _ = tocc.aabb_from_rays(T(ro), T(rd), 0.5, 4.0, pad=pad)
    np.testing.assert_array_equal(to_np(tlo), np.asarray(jlo))


def test_grid_coords_match():
    lo, hi = np.array([-1.0, -0.5, 0.25], np.float32), np.array([1.5, 0.5, 3.0], np.float32)
    np.testing.assert_array_equal(to_np(tocc.grid_coords(8, T(lo), T(hi))),
                                  np.asarray(jocc.grid_coords(8, jnp.asarray(lo), jnp.asarray(hi))))


def test_maxpool3_is_bitwise_equal():
    grid = np.random.RandomState(1).randn(9, 7, 11).astype(np.float32)
    np.testing.assert_array_equal(to_np(tocc._maxpool3(T(grid))),
                                  np.asarray(jocc._maxpool3(jnp.asarray(grid))))


def test_grid_lookup_is_bitwise_equal():
    rng = np.random.RandomState(2)
    grid = rng.rand(16, 16, 16).astype(np.float32)
    lo, hi = np.array([-1, -1, -1], np.float32), np.array([1, 2, 3], np.float32)
    # inside, on the faces, outside on every side
    pts = (rng.rand(500, 3) * 6 - 2.5).astype(np.float32)
    pts[:6] = [[-1, -1, -1], [1, 2, 3], [0.999, 1.999, 2.999], [-5, 0, 0], [0, 9, 0], [0, 0, -7]]
    np.testing.assert_array_equal(
        to_np(tocc.grid_lookup(T(grid), T(lo), T(hi), T(pts))),
        np.asarray(jocc.grid_lookup(jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(pts))))


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_bake_density_grid_is_bitwise_equal(dilate):
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)

    def density(pts, np_=jnp):  # sigma = 5 inside an r = 0.5 sphere
        return np_.where(np_.linalg.norm(pts, axis=-1) < 0.5, 5.0, 0.0)

    jg = jocc.bake_density_grid(density, jnp.asarray(lo), jnp.asarray(hi), resolution=20,
                                chunk=4096, dilate=dilate)
    tg = tocc.bake_density_grid(
        lambda p: torch.where(torch.linalg.norm(p, dim=-1) < 0.5, 5.0, 0.0),
        T(lo), T(hi), resolution=20, chunk=4096, dilate=dilate)
    assert tg.dtype == torch.float32 and tuple(tg.shape) == (20, 20, 20)
    np.testing.assert_array_equal(to_np(tg), np.asarray(jg))


# ---------------------------------------------------------------------- #
# placement
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("floor", [0.0, 0.3])
@pytest.mark.parametrize("kind", ["empty", "slab"])
@pytest.mark.parametrize("mode", ["det", "stratified"])
def test_occ_z_vals_match(floor, kind, mode):
    R, N, C = 32, 16, 128
    ro, rd = _slab_rays(R)
    near, far = np.zeros((R, 1), np.float32), np.full((R, 1), 4.0, np.float32)
    grid = _grid(kind)
    key = jax.random.PRNGKey(7) if mode == "stratified" else None
    jz = jocc.occ_z_vals(jnp.asarray(grid), jnp.asarray(SLAB_LO), jnp.asarray(SLAB_HI),
                         jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
                         jnp.asarray(far), N, n_candidates=C, floor=floor, rng=key)
    u = None if key is None else T(np.asarray(jax.random.uniform(key, (R, N))))
    tz = tocc.occ_z_vals(T(grid), T(SLAB_LO), T(SLAB_HI), T(ro), T(rd), T(near), T(far), N,
                         n_candidates=C, floor=floor, u=u)
    z = to_np(tz)
    z_edges = np.linspace(0.0, 4.0, C + 1)
    sigma = tocc.grid_lookup(T(grid), T(SLAB_LO), T(SLAB_HI), T(ro)[:, None] + T(rd)[:, None]
                             * T(0.5 * (z_edges[1:] + z_edges[:-1]), dtype=torch.float32)[:, None])
    pdf = _pdf_np(to_np(sigma).astype(np.float64), np.broadcast_to(z_edges, (R, C + 1)), floor)
    if floor > 0:
        assert pdf.min() > 1e-4
    _assert_z_close(z, np.asarray(jz), pdf, 0.0, 4.0 / C)
    assert np.all(z[:, 1:] >= z[:, :-1]) and z.min() >= 0.0 and z.max() <= 4.0
    if kind == "slab" and floor == 0.0:
        assert ((z > 1.9) & (z < 2.6)).mean() > 0.8


def test_placement_draws_from_the_generator():
    """Stratified draws come from the generator on its device; the same
    draws handed in as u give the same depths."""
    R, N = 8, 12
    ro, rd = _rays(R)

    def sigma_fn(pts):
        return torch.exp(-torch.sum(pts ** 2, -1))

    g = torch.Generator().manual_seed(5)
    a = tocc.place_from_sigma(sigma_fn, T(ro), T(rd), 0.5, 4.0, N, n_candidates=32,
                              floor=0.3, generator=g)
    u = torch.rand((R, N), generator=torch.Generator().manual_seed(5))
    b = tocc.place_from_sigma(sigma_fn, T(ro), T(rd), 0.5, 4.0, N, n_candidates=32,
                              floor=0.3, u=u)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    det = tocc.place_from_sigma(sigma_fn, T(ro), T(rd), 0.5, 4.0, N, n_candidates=32)
    assert not torch.equal(a, det)
    # a dominant floor is the uniform schedule
    flat = tocc.place_from_sigma(sigma_fn, T(ro), T(rd), 0.5, 4.0, N, n_candidates=32,
                                 floor=torch.tensor(1e6))
    np.testing.assert_allclose(to_np(flat), np.tile(0.5 + np.linspace(0, 1, N) * 3.5, (R, 1)),
                               rtol=0, atol=2e-3)


# ---------------------------------------------------------------------- #
# the proposal MLP and its distillation
# ---------------------------------------------------------------------- #


def _jax_proposal(seed=0, width=64, depth=2, multires=4):
    prop = jocc.ProposalMLP(width=width, depth=depth, multires=multires)
    params = jax.tree_util.tree_map(np.asarray, prop.init(jax.random.PRNGKey(seed)))
    # biases off their zero init, so that they are exercised
    rng = np.random.RandomState(seed + 50)
    params = {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.1 if k.startswith("b")
                  else v) for k, v in params.items()}
    return prop, params


def _port_proposal(params, width=64, depth=2, multires=4):
    prop = tocc.ProposalMLP(width, depth, multires)
    prop.load_state_dict(proposal_state_dict_from_jax(params))
    return prop


@pytest.mark.parametrize("width,depth,multires", [(64, 2, 4), (32, 3, 2)])
def test_proposal_apply_matches(width, depth, multires):
    jprop, params = _jax_proposal(1, width, depth, multires)
    prop = _port_proposal(params, width, depth, multires)
    pts = np.random.RandomState(3).rand(4, 300, 3).astype(np.float32)
    ref = np.asarray(jprop.apply(params, jnp.asarray(pts)))
    with torch.no_grad():
        got = to_np(prop(T(pts)))
    assert got.shape == (4, 300) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert set(prop.state_dict()) == set(proposal_state_dict_from_jax(
        {**params, "__meta": np.zeros(1)}))


def test_proposal_init_is_seeded_and_bounded():
    a = tocc.ProposalMLP(generator=torch.Generator().manual_seed(4))
    b = tocc.ProposalMLP(generator=torch.Generator().manual_seed(4))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    w0 = a.layers[0].weight
    bound = np.sqrt(6.0 / a.in_dim)
    assert tuple(w0.shape) == (64, 27) and float(w0.abs().max()) <= bound
    assert float(w0.abs().max()) > 0.9 * bound and not a.layers[0].bias.any()


def _slab_density(pts, np_):
    z = pts[..., 2]
    return np_.where((z >= 2.0) & (z < 2.5), 10.0, 0.0)


def test_distill_proposal_matches_jax_with_injected_draws():
    """Two epochs at 4,096 points (4 batches of 1,024): the pool, the initial
    weights and the permutations are JAX's, recomputed from its key."""
    n, batch, epochs = 4096, 1024, 2
    key = jax.random.PRNGKey(0)
    jprop, jparams, jloss = jocc.distill_proposal(
        lambda p: _slab_density(p, jnp), jnp.asarray(SLAB_LO), jnp.asarray(SLAB_HI), key,
        n_points=n, batch=batch, epochs=epochs, chunk=1024)
    # replicate JAX's draws (cfnerf_tpu/ops/occupancy.py:322-352)
    k_pts, k_init, k_perm = jax.random.split(key, 3)
    pool = np.asarray(jax.random.uniform(k_pts, (n, 3), jnp.float32))
    init = proposal_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jocc.ProposalMLP().init(k_init)))
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(k_perm, ep), n))
             for ep in range(epochs)]
    prop, loss = tocc.distill_proposal(
        lambda p: _slab_density(p, torch), T(SLAB_LO), T(SLAB_HI), torch.Generator(),
        n_points=n, batch=batch, epochs=epochs, chunk=1024,
        pts_unit=T(pool), perms=[T(p) for p in perms], init=init)
    assert loss == pytest.approx(jloss, rel=2e-4)
    want = proposal_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in prop.state_dict().items():
        got, ref = (to_np(v) - to_np(init[name]) for v in (p, want[name]))
        rel = np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))
        cos = np.sum(got * ref) / np.linalg.norm(got) / np.linalg.norm(ref)
        assert rel <= 1e-2 and cos >= 0.9999, (name, rel, cos)


def test_distill_proposal_from_the_generator_learns_the_slab():
    prop, loss = tocc.distill_proposal(
        lambda p: _slab_density(p, torch), T(SLAB_LO), T(SLAB_HI),
        torch.Generator().manual_seed(0), n_points=1 << 14, batch=1 << 10, epochs=4)
    assert loss < 0.3, loss  # targets are 0 and log(11) ~ 2.4
    ro, rd = _slab_rays()
    with torch.no_grad():
        z = tocc.place_from_sigma(tocc.make_proposal_sigma_fn(prop, T(SLAB_LO), T(SLAB_HI)),
                                  T(ro), T(rd), 0.0, 4.0, 16, n_candidates=128)
    assert float(((z > 1.8) & (z < 2.7)).float().mean()) > 0.7


def test_proposal_sigma_fn_matches():
    jprop, params = _jax_proposal(2)
    prop = _port_proposal(params)
    pts = (np.random.RandomState(4).rand(200, 3) * 6 - 2).astype(np.float32)  # some outside
    ref = jocc.make_proposal_sigma_fn(jprop, params, SLAB_LO, SLAB_HI)(jnp.asarray(pts))
    with torch.no_grad():
        got = tocc.make_proposal_sigma_fn(prop, T(SLAB_LO), T(SLAB_HI))(T(pts))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# the field's density, placed renders, serving
# ---------------------------------------------------------------------- #


def _models():
    jm, params, test_eps = jax_nerf_flows(CFG)
    return jm, params, port_nerf_flows(CFG, params, test_eps)


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_density_query_matches(reduce):
    jm, params, model = _models()
    pts = np.random.RandomState(5).randn(96, 3).astype(np.float32)
    jrc = jrender.RenderConfig(n_samples=8, use_viewdirs=True)
    ref = jocc.density_query(jm, jrc, reduce)(params, jnp.asarray(pts))
    rc = RenderConfig(n_samples=8, use_viewdirs=True)
    got = tocc.density_query(model, rc, reduce)(T(pts))
    assert not got.requires_grad
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(to_np(tocc.make_density_fn(model, rc, reduce)(T(pts))),
                                  to_np(got))
    with pytest.raises(ValueError, match="reduce"):
        tocc.density_query(model, rc, "min")


def _jax_base(jm, n):
    def apply(p, x, *, is_test, rng):
        return jm.apply({"params": p}, x, is_test=is_test, rng=rng)
    return jrender.make_render_rays(
        apply, jrender.RenderConfig(n_samples=n, perturb=False, use_viewdirs=True))


def _view_rays(R=24):
    ro, rd = _rays(R, seed=6)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd, vd, np.full((R, 1), 0.5, np.float32), np.full((R, 1), 4.0, np.float32)


@pytest.mark.parametrize("proxy", ["grid", "proposal"])
def test_placed_render_matches(proxy):
    """Test mode through the render core's plain version, placed depths
    from a grid (make_occ_render_rays) or the proposal
    (make_placed_render_rays), against JAX's unfused render of them."""
    N = 16
    jm, params, model = _models()
    rays = _view_rays()
    lo, hi = jocc.aabb_from_rays(rays[0], rays[1], rays[3], rays[4])
    lo, hi = np.asarray(lo), np.asarray(hi)
    base = make_render_rays(model, RenderConfig(n_samples=N, perturb=False))
    if proxy == "grid":
        grid = np.exp(np.random.RandomState(3).randn(16, 16, 16)).astype(np.float32)
        jr = jocc.make_occ_render_rays(_jax_base(jm, N), grid, lo, hi, N, n_candidates=64,
                                       floor=0.3)
        tr = tocc.make_occ_render_rays(base, T(grid), T(lo), T(hi), N, n_candidates=64,
                                       floor=0.3)
    else:
        jprop, pparams = _jax_proposal(3)
        jr = jocc.make_placed_render_rays(
            _jax_base(jm, N), jocc.make_proposal_sigma_fn(jprop, pparams, lo, hi), N,
            n_candidates=32, floor=0.3)
        tr = tocc.make_placed_render_rays(
            base, tocc.make_proposal_sigma_fn(_port_proposal(pparams), T(lo), T(hi)), N,
            n_candidates=32, floor=0.3)
    ref = jr(params, *map(jnp.asarray, rays), None, is_test=True)
    with torch.no_grad():
        out = tr(*map(T, rays), None, is_test=True)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]), err_msg=k, **MAP_TOL)


def test_placed_render_train_mode_draws_placement_first():
    """In train mode the placement's u come from the generator before the
    base renderer's draws; place_u injects them."""
    N = 8
    _, _, model = _models()
    rays = [T(a) for a in _view_rays(8)]
    base = make_render_rays(model, RenderConfig(n_samples=N))
    placed = tocc.make_placed_render_rays(base, lambda p: torch.exp(-(p ** 2).sum(-1)), N,
                                          n_candidates=32, floor=0.3)
    with torch.no_grad():
        a = placed(*rays, torch.Generator().manual_seed(1), is_test=False)
        g = torch.Generator().manual_seed(1)
        u = torch.rand((8, N), generator=g)
        b = placed(*rays, g, is_test=False, place_u=u)
    torch.testing.assert_close(a["rgb_map"], b["rgb_map"], rtol=0, atol=0)
    assert bool(torch.isfinite(a["rgb_map"]).all())


def _scene():
    def c2w(theta):
        t = np.radians(theta)
        rot = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])
        return np.concatenate([rot, rot @ np.array([[0.0], [0.0], [4.0]])], 1).astype(np.float32)

    return dict(H=12, W=10, focal=12.0, i_train=[0, 2], poses=np.stack([c2w(a) for a in
                (0.0, 45.0, 120.0)]), near=2.0, far=6.0)


def _args(**over):
    base = dict(dataset_type="blender", no_ndc=False, use_viewdirs=True, occ_impl="grid",
                occ_res=8, occ_dilate=1, occ_candidates=128, occ_eval_candidates=32,
                occ_floor=0.3, seed=0)
    return types.SimpleNamespace(**{**base, **over})


@pytest.mark.parametrize("over", [dict(), dict(dataset_type="llff")], ids=["blender", "ndc"])
def test_aabb_from_scene_matches(over):
    args = _args(**over)
    jlo, jhi = jocc.aabb_from_scene(_scene(), args)
    tlo, thi = tocc.aabb_from_scene(_scene(), args, device="cpu")
    np.testing.assert_allclose(to_np(tlo), np.asarray(jlo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(thi), np.asarray(jhi), rtol=1e-6, atol=1e-6)


def test_aabb_from_scene_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tocc.aabb_from_scene(_scene(), _args())


@pytest.mark.parametrize("over,want", [
    (dict(), 32), (dict(occ_eval_candidates=96), 96),
    (dict(occ_eval_candidates=0, occ_candidates=192), 192)])
def test_serving_candidates(over, want):
    args = _args(**over)
    assert tocc.serving_candidates(args) == jocc.serving_candidates(args) == want


@pytest.mark.parametrize("impl", ["grid", "auto"])
def test_wrap_renderer_for_serving_grid_matches(impl):
    """auto means the grid off a TPU, in both packages."""
    N = 8
    jm, params, model = _models()
    scene, args = _scene(), _args(occ_impl=impl)
    jrc = jrender.RenderConfig(n_samples=N, perturb=False, use_viewdirs=True)
    jr = jocc.wrap_renderer_for_serving(_jax_base(jm, N), args, scene, jm, params, jrc)
    rc = RenderConfig(n_samples=N, perturb=False)
    tr = tocc.wrap_renderer_for_serving(make_render_rays(model, rc), args, scene, model, rc)
    assert tr.placement["impl"] == "grid" and 0.0 <= tr.placement["occupied"] <= 1.0
    rays = _view_rays(12)
    ref = jr(params, *map(jnp.asarray, rays), None, is_test=True)
    with torch.no_grad():
        out = tr(*map(T, rays), None, is_test=True)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]), err_msg=k, **MAP_TOL)


def test_wrap_renderer_for_serving_proposal(monkeypatch):
    """The proposal backend distils from the model (here a small pool) and
    serves finite, sorted placements; an unknown backend raises."""
    monkeypatch.setattr(tocc, "distill_proposal", functools.partial(
        tocc.distill_proposal, n_points=4096, batch=1024, epochs=1))
    _, _, model = _models()
    rc = RenderConfig(n_samples=8, perturb=False)
    tr = tocc.wrap_renderer_for_serving(make_render_rays(model, rc),
                                        _args(occ_impl="proposal"), _scene(), model, rc)
    assert tr.placement["impl"] == "proposal" and np.isfinite(tr.placement["final_loss"])
    with torch.no_grad():
        out = tr(*map(T, _view_rays(12)), None, is_test=True)
    assert bool(torch.isfinite(out["rgb_map"]).all())
    with pytest.raises(ValueError, match="occ_impl"):
        tocc.wrap_renderer_for_serving(make_render_rays(model, rc), _args(occ_impl="voxel"),
                                       _scene(), model, rc)
