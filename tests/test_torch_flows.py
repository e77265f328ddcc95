"""Triangular Sylvester flows and their amortization: port vs cfnerf_tpu.

Tolerance rtol 1e-5 / atol 1e-5: both sides run the same f32 chains; tanh
and log differ between the two libraries' CPU kernels in the last ulp, and
a four-step chain with unit-scale coefficients amplifies that to ~2e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.flows.amortized import AmortizedTriangularSylvester as JaxAmortized
from cfnerf_tpu.flows.sylvester import (
    triangular_sylvester_stack as jax_stack,
    triangular_sylvester_step as jax_step,
)
from cfnerf_torch.convert import _dense
from cfnerf_torch.flows.amortized import AmortizedTriangularSylvester
from cfnerf_torch.flows.sylvester import (
    triangular_sylvester_stack,
    triangular_sylvester_step,
)
from tests.test_torch_common import to_np

T = torch.as_tensor
TOL = dict(rtol=1e-5, atol=1e-5)


def _flow_inputs(B, K, Z, F, seed):
    rng = np.random.RandomState(seed)
    z0 = rng.randn(B, K, Z).astype(np.float32)
    r1 = np.triu(rng.randn(B, F, Z, Z)).transpose(0, 2, 3, 1).astype(np.float32)
    r2 = np.triu(rng.randn(B, F, Z, Z)).transpose(0, 2, 3, 1).astype(np.float32)
    b = rng.randn(B, Z, F).astype(np.float32)
    return z0, r1, r2, b


@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("compute_log_det", [True, False])
def test_stack_matches(Z, compute_log_det):
    z0, r1, r2, b = _flow_inputs(40, 6, Z, 4, seed=Z)
    jz, jl = jax_stack(*map(jnp.asarray, (z0, r1, r2, b)),
                       compute_log_det=compute_log_det)
    tz, tl = triangular_sylvester_stack(*map(T, (z0, r1, r2, b)),
                                        compute_log_det=compute_log_det)
    np.testing.assert_allclose(to_np(tz), np.asarray(jz), **TOL)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    if not compute_log_det:
        assert float(tl.abs().max()) == 0.0


@pytest.mark.parametrize("flip", [False, True])
def test_step_matches_with_flip(flip):
    z0, r1, r2, b = _flow_inputs(30, 5, 3, 1, seed=7)
    args = (z0, r1[..., 0], r2[..., 0], b[..., 0])
    jz, jl = jax_step(*map(jnp.asarray, args), flip=flip)
    tz, tl = triangular_sylvester_step(*map(T, args), flip=flip)
    np.testing.assert_allclose(to_np(tz), np.asarray(jz), **TOL)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)


def test_stack_logdet_floor_keeps_finite():
    # diag(r1) * diag(r2) = -1 at tanh' = 1 makes 1 + ... exactly 0: the
    # 1e-8 floor keeps log finite
    z0 = torch.zeros(2, 3, 1)
    r1 = torch.ones(2, 1, 1, 1)
    r2 = -torch.ones(2, 1, 1, 1)
    b = torch.zeros(2, 1, 1)
    _, ldj = triangular_sylvester_stack(z0, r1, r2, b)
    assert torch.all(torch.isfinite(ldj))


@pytest.mark.parametrize("Z,F", [(1, 4), (3, 4), (3, 2)])
def test_amortized_on_converted_weights(Z, F):
    import jax

    h_size, B = 16, 25
    jmod = JaxAmortized(Z, F)
    h = np.random.RandomState(Z + F).randn(B, h_size).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(Z), jnp.asarray(h))["params"]
    jr1, jr2, jb = jmod.apply({"params": params}, jnp.asarray(h))

    mod = AmortizedTriangularSylvester(h_size, Z, F)
    sd = {}
    for name in ("amor_d", "amor_diag1", "amor_diag2", "amor_b"):
        _dense(sd, name, {k: np.asarray(v) for k, v in params[name].items()})
    mod.load_state_dict(sd)
    r1, r2, b = mod(T(h))
    assert tuple(r1.shape) == (B, Z, Z, F) and tuple(b.shape) == (B, Z, F)
    for a, ref in ((r1, jr1), (r2, jr2), (b, jb)):
        np.testing.assert_allclose(to_np(a), np.asarray(ref), **TOL)
    # strictly lower triangle is zero; diagonals are tanh-bounded
    low = torch.tril(torch.ones(Z, Z), -1).bool()
    if Z > 1:
        assert float(r1.permute(0, 3, 1, 2)[..., low].abs().max()) == 0.0
    assert float(torch.diagonal(r2, dim1=1, dim2=2).abs().max().detach()) < 1.0
