"""The render-core kernels' segmented arithmetic, in its plain PyTorch
mirror, against cfnerf_tpu's fused_flow_composite (the Pallas kernels run
through their interpreter on the CPU).

The CUDA kernels cut each ray's samples into contiguous segments, one per
warp, and join them: T at a segment's start is the exclusive product of the
earlier segments' products of x = 1 - alpha + 1e-10; the backward's C
recurrence crosses a segment as the affine map C_in = Y + P C_out.  The
mirrors (`fused_flow_composite_bwd_segmented`, `fused_flow_composite_
segmented`) do the same algebra in eager PyTorch, so a slip in it shows
here, on the CPU, before any card runs the kernels.
"""
import functools

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.render_core import fused_flow_composite as jax_fused
from cfnerf_torch.ops.kernels.render_core import (
    MAX_SEG,
    SEG_WARPS,
    fused_flow_composite_bwd_plain,
    fused_flow_composite_bwd_segmented,
    fused_flow_composite_plain,
    fused_flow_composite_segmented,
    kernel_segments,
    segment_bounds,
)
from tests.test_torch_common import dists_np, render_core_inputs, to_np
from tests.test_torch_render_core import (
    ORDER,
    _assert_matches,
    _cotangents,
    _model_like,
)

# (S, K, saturate, compute_log_det, F): the JAX kernel takes R % 128 == 0
# and an S whose rays tile 128 lanes (3, 6, 24, ...); F = 12 is past the
# steps the backward kernel keeps in registers (its generic path)
SHAPES = {
    "S6": (6, 8, False, True, 2),
    "S3_saturated": (3, 8, True, True, 2),
    "S24_K40_saturated": (24, 40, True, True, 2),
    "S24_test_mode": (24, 8, False, False, 2),
    "S6_F12": (6, 4, True, True, 12),
}
# (shape, segments, rounds): counts 1, 2 and 4; S not divisible by the
# count (6 / 4 leaves an empty segment, 3 / 2 a short one); two rounds
CASES = [
    ("S6", 1, 1), ("S6", 2, 1), ("S6", 4, 1),
    ("S3_saturated", 2, 1), ("S3_saturated", 4, 1),
    ("S24_K40_saturated", 4, 1), ("S24_K40_saturated", 5, 2),
    ("S24_test_mode", 4, 1), ("S24_test_mode", 8, 1),
    ("S6_F12", 8, 1), ("S6_F12", 4, 2),
]
R, F = 128, 2


@functools.lru_cache(maxsize=None)
def _case(shape):
    S, K, saturate, cld, F = SHAPES[shape]
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=11, saturate=saturate)
    args = _model_like(args)
    inputs = [args[k] for k in ORDER] + [z_vals.ravel(), dists_np(z_vals, rays_d).ravel()]
    cots = _cotangents(R, K, seed=12)
    out, vjp = jax.vjp(lambda *a: jax_fused(*a, S, cld, True),
                       *[jnp.asarray(a) for a in inputs])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return (inputs, cots, [np.asarray(o) for o in out],
            [np.asarray(g) for g in grads[:8]])


@pytest.mark.parametrize("shape,n_seg,rounds", CASES)
def test_segmented_backward_matches_jax_vjp(shape, n_seg, rounds):
    """rtol 1e-4 / atol 1e-6: the rule of the plain backward's JAX test."""
    S, K, saturate, cld, _ = SHAPES[shape]
    inputs, cots, _, ref = _case(shape)
    out = fused_flow_composite_bwd_segmented(
        [torch.as_tensor(a) for a in inputs], [torch.as_tensor(c) for c in cots],
        S, cld, n_seg, rounds)
    for name, a, b in zip(ORDER, out, ref):
        a = to_np(a)
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)
    lower = np.tril(np.ones((3, 3), bool), -1)
    assert not to_np(out[5])[:, lower].any() and not to_np(out[6])[:, lower].any()


@pytest.mark.parametrize("shape,n_seg,rounds", CASES)
def test_segmented_forward_matches_jax(shape, n_seg, rounds):
    """Tolerances of the plain forward's JAX test (rtol 2e-5, atol 2e-4,
    ldj 2e-5 relative)."""
    S, _, _, cld, _ = SHAPES[shape]
    inputs, _, ref, _ = _case(shape)
    out = fused_flow_composite_segmented(*[torch.as_tensor(a) for a in inputs], S, cld,
                                         n_seg, rounds)
    _assert_matches(out, ref, rtol=2e-5, atol=2e-4, ldj_rtol=2e-5)


@pytest.mark.parametrize("S", [1, 20, 128, 129, 300])
def test_kernel_cut_covers_each_ray_in_order(S):
    bounds = kernel_segments(S)
    assert len(bounds) % SEG_WARPS == 0
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert a <= b == c
    assert max(b - a for a, b in bounds) <= MAX_SEG
    if S <= SEG_WARPS * MAX_SEG:  # one round: the segments split S evenly
        assert len(bounds) == SEG_WARPS
        assert max(b - a for a, b in bounds) == -(-S // SEG_WARPS)


@pytest.mark.parametrize("S,K", [(129, 4), (1, 3), (20, 33)])
def test_kernel_cut_matches_the_plain_versions(S, K):
    """At the kernels' own cut, where the JAX kernel cannot go (S = 129:
    two rounds; S = 1; S = 20 with K = 33), against the plain versions
    (autograd through cumprod).  The backward at rtol 1e-4 / atol 1e-6,
    the forward at 2e-5 / 2e-4 / ldj 2e-5."""
    R_small = 6
    args, z_vals, rays_d = render_core_inputs(R_small, S, K, F, seed=13, saturate=True)
    args = _model_like(args)
    x = [torch.as_tensor(args[k]) for k in ORDER] + [
        torch.as_tensor(z_vals.ravel()), torch.as_tensor(dists_np(z_vals, rays_d).ravel())]
    cots = [torch.as_tensor(c) for c in _cotangents(R_small, K, seed=14)]
    rounds = -(-S // (SEG_WARPS * MAX_SEG))
    assert segment_bounds(S, SEG_WARPS, rounds) == kernel_segments(S)
    out = fused_flow_composite_bwd_segmented(x, cots, S, True, SEG_WARPS, rounds)
    ref = fused_flow_composite_bwd_plain(x, cots, S, True)
    for name, a, b in zip(ORDER, out, ref):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-4, atol=1e-6, err_msg=name)
    fwd = fused_flow_composite_segmented(*x, S, True, SEG_WARPS, rounds)
    _assert_matches(fwd, fused_flow_composite_plain(*x, S, True), rtol=2e-5, atol=2e-4,
                    ldj_rtol=2e-5)
