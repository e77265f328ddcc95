"""The port's batch sampler and host-side rays against cfnerf_tpu's: the
same seeds give the same arrays, batch for batch, over two epochs."""
import numpy as np
import pytest

from cfnerf_tpu.data import sampler as jsampler
from cfnerf_tpu.ops import rays as jrays
from cfnerf_torch.data import sampler as tsampler
from cfnerf_torch.ops import rays as trays


def _scene(seed=0, n=4, H=6, W=5):
    rng = np.random.RandomState(seed)
    images = rng.rand(n, H, W, 3).astype(np.float32)
    poses = np.concatenate([np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1)),
                            np.zeros((n, 3, 1), np.float32)], -1)  # (n, 3, 5)
    poses[:, :3, 3] = rng.randn(n, 3)
    poses[:, :3, :3] += rng.randn(n, 3, 3).astype(np.float32) * 0.1
    depth_gts = []
    for i in range(n):
        m = 0 if i == 1 else rng.randint(3, 9)  # image 1 has no keypoints
        depth_gts.append({"depth": rng.uniform(2, 6, m).astype(np.float32),
                          "coord": rng.uniform(0, [W, H], (m, 2)).astype(np.float32),
                          "weight": rng.rand(m).astype(np.float32)})
    return images, poses, depth_gts


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_rays_np_match():
    _, poses, depth_gts = _scene()
    for a, b in zip(trays.get_rays_np(6, 5, 7.0, poses[0, :3, :4]),
                    jrays.get_rays_np(6, 5, 7.0, poses[0, :3, :4])):
        np.testing.assert_array_equal(a, b)
    coords = depth_gts[0]["coord"]
    for a, b in zip(trays.get_rays_by_coord_np(6, 5, 7.0, poses[2, :3, :4], coords),
                    jrays.get_rays_by_coord_np(6, 5, 7.0, poses[2, :3, :4], coords)):
        np.testing.assert_array_equal(a, b)


def test_ray_batchers_match_over_two_epochs():
    images, poses, depth_gts = _scene()
    idx = [0, 2, 3]
    rays = tsampler.precompute_rays(images, poses, 7.0, idx, seed=3)
    np.testing.assert_array_equal(rays, jsampler.precompute_rays(images, poses, 7.0, idx, seed=3))
    drays = tsampler.precompute_depth_rays(depth_gts, poses, 6, 5, 7.0, [0, 1, 2, 3], seed=3)
    np.testing.assert_array_equal(
        drays, jsampler.precompute_depth_rays(depth_gts, poses, 6, 5, 7.0, [0, 1, 2, 3], seed=3))

    # 90 rays in batches of 16 and the depth rays in batches of 4: the
    # batchers wrap twice, including a partial tail
    t, j = tsampler.RayBatcher(rays, 16, seed=1), jsampler.RayBatcher(rays, 16, seed=1)
    td, jd = tsampler.DepthRayBatcher(drays, 4, seed=1), jsampler.DepthRayBatcher(drays, 4, seed=1)
    for _ in range(12):
        _assert_same(t.next(), j.next())
        _assert_same(td.next(), jd.next())
    assert t.epoch == j.epoch == 2
    assert tsampler.N_DEPTH == 128


@pytest.mark.parametrize("precrop_iters", [0, 3])
def test_single_image_sampler_matches(precrop_iters):
    images, poses, _ = _scene()
    kw = dict(precrop_iters=precrop_iters, precrop_frac=0.5, seed=2)
    t = tsampler.SingleImageSampler(images, poses, 7.0, [0, 2, 3], 8, **kw)
    j = jsampler.SingleImageSampler(images, poses, 7.0, [0, 2, 3], 8, **kw)
    for step in range(6):
        _assert_same(t.next(step), j.next(step))


@pytest.mark.parametrize("name,n,hold", [("africa", 20, 8), ("fern", 20, 8),
                                         ("fern", 20, 0), ("lego", 10, 0)])
def test_scene_splits_match(name, n, hold):
    i_test = np.array([4]) if name == "fern" else None
    assert (tsampler.lf_scene_splits(name, n, hold, i_test)
            == jsampler.lf_scene_splits(name, n, hold, i_test))
