"""The flow stack's plain version against cfnerf_tpu's fused_flow_stack (the
Pallas kernel run through its interpreter on the CPU), forward and VJP; the
wrapper's routing, with stand-in kernel entries; the sources' build list.

The CUDA kernels themselves cannot run here (no card, no nvcc):
chip_smoke.py holds them against this plain version on the H100.

Tolerances: z and ldj rtol = atol = 1e-5, the rule of
tests/test_pallas_flow.py's forward check (both sides do the same f32 steps,
in another fusion order); gradients rtol = atol = 1e-5 (the Pallas backward
sums the per-point gradients over K by a reduction, autograd by its own
sum over the expanded axis).
"""
import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.flow_stack import fused_flow_stack as jax_flow_stack
from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels import flow_stack
from cfnerf_torch.ops.kernels.flow_stack import (
    fused_flow_stack,
    fused_flow_stack_bwd,
    fused_flow_stack_bwd_plain,
    fused_flow_stack_plain,
)
from tests.test_torch_common import to_np

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.as_tensor


def flow_inputs(B, K, Z, F, seed=0, shared_z0=False):
    """Numpy inputs shaped as the amortization gives them
    (tests/test_pallas_flow.py:_inputs): upper-triangular r1/r2 with
    tanh-bounded diagonals; z0 (B, K, Z), or shared (K, Z) draws when
    `shared_z0` (the model's case), returned as they are."""
    rng = np.random.RandomState(seed)
    triu = np.triu(np.ones((Z, Z), np.float32), 1)[None, :, :, None]
    eye = np.eye(Z, dtype=np.float32)[None, :, :, None]
    full = rng.randn(B, Z, Z, F).astype(np.float32)
    d1 = np.tanh(rng.randn(B, Z, F)).astype(np.float32)
    d2 = np.tanh(rng.randn(B, Z, F)).astype(np.float32)
    r1 = full * triu + eye * d1[:, :, None, :]
    r2 = np.swapaxes(full, 1, 2) * triu + eye * d2[:, :, None, :]
    b = rng.randn(B, Z, F).astype(np.float32)
    z0 = rng.randn(*((K, Z) if shared_z0 else (B, K, Z))).astype(np.float32)
    return z0, np.ascontiguousarray(r1), np.ascontiguousarray(r2), b


def _z0_of(z0, B):
    """The port's z0: shared draws expanded over the points (the model's
    layout, never materialised) or the (B, K, Z) tensor itself."""
    z0 = T(z0)
    return z0[None].expand(B, *z0.shape) if z0.ndim == 2 else z0


def _jax_fwd_vjp(z0, r1, r2, b, compute_log_det, cots):
    """JAX's kernel (interpreted): outputs and the VJP of `cots`."""
    B = r1.shape[0]
    z0 = np.broadcast_to(z0, (B, *z0.shape)) if z0.ndim == 2 else z0
    out, vjp = jax.vjp(lambda *a: jax_flow_stack(*a, compute_log_det, True),
                       *map(jnp.asarray, (z0, r1, r2, b)))
    return out, vjp(tuple(map(jnp.asarray, cots)))


@pytest.mark.parametrize("shared_z0", [True, False], ids=["expanded_z0", "dense_z0"])
@pytest.mark.parametrize("compute_log_det", [True, False])
@pytest.mark.parametrize("Z", [1, 3])
def test_plain_matches_jax_kernel_forward_and_vjp(Z, compute_log_det, shared_z0):
    B, K, F = 96, 8, 3
    z0, r1, r2, b = flow_inputs(B, K, Z, F, seed=Z, shared_z0=shared_z0)
    rng = np.random.RandomState(10 + Z)
    cots = (rng.randn(B, K, Z).astype(np.float32), rng.randn(B, K).astype(np.float32))
    (jz, jldj), jgrads = _jax_fwd_vjp(z0, r1, r2, b, compute_log_det, cots)

    inputs = [_z0_of(z0, B), T(r1), T(r2), T(b)]
    z, ldj = fused_flow_stack(*inputs, compute_log_det)
    np.testing.assert_allclose(to_np(z), np.asarray(jz), err_msg="z", **FWD_TOL)
    np.testing.assert_allclose(to_np(ldj), np.asarray(jldj), err_msg="ldj", **FWD_TOL)
    if not compute_log_det:
        assert not to_np(ldj).any()

    grads = fused_flow_stack_bwd(inputs, [T(c) for c in cots], compute_log_det)
    for name, a, j in zip(("g_z0", "g_r1", "g_r2", "g_b"), grads, jgrads):
        assert tuple(a.shape) == tuple(j.shape), name
        np.testing.assert_allclose(to_np(a), np.asarray(j), err_msg=name, **GRAD_TOL)
    lower = np.tril(np.ones((Z, Z), bool), -1)
    for g in grads[1:3]:
        assert not to_np(g)[:, lower].any()  # strictly lower entries: zero


@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("B,K,F", [(61, 7, 4), (96, 8, 1), (40, 32, 9)],
                         ids=["K7_ragged_B61", "F1", "F9"])
def test_plain_matches_jax_kernel_at_the_kernels_edges(B, K, F, Z):
    """The shapes where the kernels take other code (chip_smoke.py holds
    them against this plain version): an odd K whose point runs are not a
    multiple of 16 bytes, F = 1 and F = 9 (every F but 4 takes the
    runtime-F code), in train mode, forward and VJP against JAX's kernel.
    Tolerances as above, but at F = 9: nine steps of these unit-scale
    parameters carry each side's f32 roundings further (the rgb chain's
    worst element measured at 3.2x the F <= 4 rule of rtol = atol = 1e-5
    in either mode), so rtol = atol = 1e-4 there."""
    z0, r1, r2, b = flow_inputs(B, K, Z, F, seed=B + F, shared_z0=True)
    rng = np.random.RandomState(20 + Z)
    cots = (rng.randn(B, K, Z).astype(np.float32), rng.randn(B, K).astype(np.float32))
    (jz, jldj), jgrads = _jax_fwd_vjp(z0, r1, r2, b, True, cots)
    fwd_tol, grad_tol = (FWD_TOL, GRAD_TOL) if F <= 4 else ((dict(rtol=1e-4, atol=1e-4),) * 2)
    inputs = [_z0_of(z0, B), T(r1), T(r2), T(b)]
    z, ldj = fused_flow_stack(*inputs, True)
    np.testing.assert_allclose(to_np(z), np.asarray(jz), err_msg="z", **fwd_tol)
    np.testing.assert_allclose(to_np(ldj), np.asarray(jldj), err_msg="ldj", **fwd_tol)
    grads = fused_flow_stack_bwd(inputs, [T(c) for c in cots], True)
    for name, a, j in zip(("g_z0", "g_r1", "g_r2", "g_b"), grads, jgrads):
        np.testing.assert_allclose(to_np(a), np.asarray(j), err_msg=name, **grad_tol)


def test_autograd_through_the_expanded_draws_sums_over_the_points():
    """The model's case: the gradient of the shared (K, Z) draws is the
    kernel-shaped (B, K, Z) gradient summed over the points."""
    B, K, Z, F = 40, 5, 3, 2
    z0, r1, r2, b = flow_inputs(B, K, Z, F, seed=4, shared_z0=True)
    shared = T(z0).requires_grad_()
    z, ldj = fused_flow_stack(shared[None].expand(B, K, Z), T(r1), T(r2), T(b), True)
    gz = torch.randn(B, K, Z, generator=torch.Generator().manual_seed(1))
    (z * gz).sum().backward()
    per_point = fused_flow_stack_bwd([shared.detach()[None].expand(B, K, Z), T(r1),
                                      T(r2), T(b)], [gz, None], True)[0]
    torch.testing.assert_close(shared.grad, per_point.sum(0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["Z=2", "r2_shape", "z0_rank"])
def test_shape_checks(bad):
    B, K, Z, F = 4, 3, 3, 2
    z0, r1, r2, b = (T(a) for a in flow_inputs(B, K, Z, F))
    if bad == "Z=2":
        z0, r1, r2, b = z0[..., :2], r1[:, :2, :2], r2[:, :2, :2], b[:, :2]
    elif bad == "r2_shape":
        r2 = r2[..., :1]
    else:
        z0 = z0[0]
    with pytest.raises(ValueError):
        fused_flow_stack(z0, r1, r2, b, True)


# ---------------------------------------------------------------------- #
# routing: CPU -> plain; CUDA -> kernel or raise; never a quiet fallback
# ---------------------------------------------------------------------- #


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the routing can be
    tested on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Entry:
    """A stand-in for a ctypes kernel entry: records each call's arguments
    and runs `body` on them; returns 0 (no CUDA error)."""

    argtypes = None
    restype = None

    def __init__(self, body):
        self.calls, self.body = [], body

    def __call__(self, *a):
        self.calls.append(a)
        self.body(*a)
        return 0


class _Lib:
    def __init__(self, **entries):
        self.__dict__.update(entries)


def _floats(ptr, n):
    """The n float32 values at a host address, as a writable numpy view."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


@contextlib.contextmanager
def _no_cuda_context():
    yield 0  # stream handle


def _no_plain(*a, **k):
    raise AssertionError("a plain version ran for a CUDA tensor")


def test_cpu_route_is_plain_and_counts_no_launch():
    B, K, Z, F = 6, 4, 3, 2
    z0, r1, r2, b = flow_inputs(B, K, Z, F, seed=2, shared_z0=True)
    x = [_z0_of(z0, B), T(r1), T(r2), T(b)]
    cots = [torch.ones(B, K, Z), torch.ones(B, K)]
    before = fused_flow_stack.launches, fused_flow_stack_bwd.launches
    for cld in (True, False):
        for a, p in zip(fused_flow_stack(*x, cld), fused_flow_stack_plain(*x, cld)):
            torch.testing.assert_close(a, p, rtol=0, atol=0)
        for a, p in zip(fused_flow_stack_bwd(x, cots, cld),
                        fused_flow_stack_bwd_plain(x, cots, cld)):
            torch.testing.assert_close(a, p, rtol=0, atol=0)
    assert (fused_flow_stack.launches, fused_flow_stack_bwd.launches) == before


def test_cuda_route_with_gradients_goes_through_both_kernels(monkeypatch):
    """Expanded z0 reaches the kernels with point stride 0 (no copy); the
    cotangents arrive contiguous, an unused one as zeros; the backward's
    gradients come back through autograd, g_z0 summed over the points."""
    B, K, Z, F = 5, 4, 3, 2
    seen = {}

    def fwd(*a):  # z0, stride, r1, r2, b, z, ldj, B, K, Z, F, cld, stream
        seen["fwd"] = (a[1], *a[7:12])
        _floats(a[5], B * K * Z)[:] = 0.5
        _floats(a[6], B * K)[:] = 0.0

    def bwd(*a):  # z0, stride, r1, r2, b, g_z, g_ldj, g_z0, g_r1, g_r2, g_b, ints
        seen["bwd"] = (a[1], *a[11:16])
        seen["g_z"] = _floats(a[5], B * K * Z).copy()
        seen["g_ldj"] = _floats(a[6], B * K).copy()
        for ptr, n in zip(a[7:11], (B * K * Z, B * Z * Z * F, B * Z * Z * F, B * Z * F)):
            _floats(ptr, n)[:] = 2.0

    entries = {"flow_stack": _Lib(flow_stack_fwd=_Entry(fwd)),
               "flow_stack_bwd": _Lib(flow_stack_bwd=_Entry(bwd))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(flow_stack, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(flow_stack, "fused_flow_stack_plain", _no_plain)
    monkeypatch.setattr(flow_stack, "fused_flow_stack_bwd_plain", _no_plain)

    z0, r1, r2, b = flow_inputs(B, K, Z, F, seed=3, shared_z0=True)
    shared = T(z0).as_subclass(_OnCuda).requires_grad_()
    params = [T(a).as_subclass(_OnCuda).requires_grad_() for a in (r1, r2, b)]
    before = fused_flow_stack.launches, fused_flow_stack_bwd.launches
    z, ldj = fused_flow_stack(shared[None].expand(B, K, Z), *params, False)
    (3.0 * z.mean(-1)).sum().backward()  # ldj unused

    assert fused_flow_stack.launches == before[0] + 1
    assert fused_flow_stack_bwd.launches == before[1] + 1
    assert seen["fwd"] == (0, B, K, Z, F, 0) and seen["bwd"] == (0, B, K, Z, F, 0)
    np.testing.assert_array_equal(seen["g_z"], np.full(B * K * Z, 1.0, np.float32))
    assert not seen["g_ldj"].any()
    assert shared.grad is not None and bool((shared.grad == 2.0 * B).all())
    for p in params:
        assert p.grad is not None and bool((p.grad == 2.0).all())


def test_cuda_route_without_gradients_launches_the_forward_only(monkeypatch):
    B, K, Z, F = 3, 2, 1, 4
    calls = []
    entries = {"flow_stack": _Lib(flow_stack_fwd=_Entry(lambda *a: calls.append(a[1])))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(flow_stack, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(flow_stack, "fused_flow_stack_plain", _no_plain)
    x = [T(a).as_subclass(_OnCuda) for a in flow_inputs(B, K, Z, F)]
    with torch.no_grad():
        fused_flow_stack(*x, True)
    assert calls == [K * Z]  # a dense z0: its point stride is K*Z


def test_cuda_route_raises_instead_of_falling_back(monkeypatch):
    def failed_build(name):
        raise RuntimeError("kernel build failed: simulated")

    monkeypatch.setattr(flow_stack, "fused_flow_stack_plain", _no_plain)
    monkeypatch.setattr(_build, "load", failed_build)
    x = [T(a).as_subclass(_OnCuda) for a in flow_inputs(4, 3, 3, 2)]
    before = fused_flow_stack.launches
    with pytest.raises(RuntimeError, match="build failed"):
        fused_flow_stack(*x, False)
    assert fused_flow_stack.launches == before


def test_kernel_refuses_strided_inputs(monkeypatch):
    """The kernels read r1/r2/b contiguous and z0 dense or as an expanded
    contiguous block; anything else raises before a launch."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no launch expected"))
    B, K, Z, F = 4, 3, 3, 2
    z0, r1, r2, b = (T(a) for a in flow_inputs(B, K, Z, F))
    strided_r2 = r2.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flow_stack._launch((z0, r1, strided_r2, b), True)
    with pytest.raises(ValueError, match="expanded"):
        flow_stack._launch((z0.transpose(0, 1).contiguous().transpose(0, 1), r1, r2, b), True)


def test_other_devices_and_mixed_devices_raise():
    x = [T(a) for a in flow_inputs(4, 3, 3, 2)]
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fused_flow_stack(*[t.to("meta") for t in x], False)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fused_flow_stack(x[0].as_subclass(_OnCuda), *x[1:], False)


def test_kernel_sources_are_built_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert {"flow_stack", "flow_stack_bwd"} <= set(_build.KERNELS)
    for name, entry, replaces in (
        ("flow_stack", "flow_stack_fwd", "flow_stack.py:_fwd_kernel"),
        ("flow_stack_bwd", "flow_stack_bwd", "flow_stack.py:_bwd_kernel"),
    ):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {entry}' in src
        assert f"cfnerf_tpu/ops/pallas/{replaces}" in src
        assert '#include "flow_stack.cuh"' in src
    assert flow_stack.REPLACES == "cfnerf_tpu/ops/pallas/flow_stack.py:109"
    assert flow_stack.REPLACES_BWD == "cfnerf_tpu/ops/pallas/flow_stack.py:125"
