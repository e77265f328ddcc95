"""The render core's plain version against cfnerf_tpu's fused_flow_composite
(the Pallas kernel run through its interpreter on the CPU) and against the
JAX unfused pipeline; the wrapper's routing; the kernel build.

The CUDA kernel itself cannot run here (no card, no nvcc): chip_smoke.py
holds it against this plain version on the H100.
"""
import contextlib
import ctypes
import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.flows.sylvester import triangular_sylvester_stack as jax_stack
from cfnerf_tpu.ops.compositing import raw2outputs as jax_raw2outputs
from cfnerf_tpu.ops.pallas.render_core import fused_flow_composite as jax_fused
from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels import render_core
from cfnerf_torch.ops.kernels.render_core import (
    fused_flow_composite,
    fused_flow_composite_bwd,
    fused_flow_composite_bwd_plain,
    fused_flow_composite_plain,
)
from tests.test_torch_common import dists_np, render_core_inputs, to_np

ORDER = ("z0_a", "r1_a", "r2_a", "b_a", "z0_r", "r1_r", "r2_r", "b_r")
NAMES = ("rgb", "depth", "acc", "ldj")


def _port_args(args, z_vals, rays_d):
    flat = [torch.as_tensor(args[k]) for k in ORDER]
    return flat + [torch.as_tensor(z_vals.ravel()),
                   torch.as_tensor(dists_np(z_vals, rays_d).ravel())]


def _jax_unfused(args, z_vals, rays_d, compute_log_det):
    """cfnerf_tpu's flows + corrections + raw2outputs, in the kernel's output
    signature (as tests/test_render_core.py:unfused)."""
    R, S = z_vals.shape
    K = args["z0_a"].shape[0]
    B = R * S
    a = {k: jnp.asarray(v) for k, v in args.items()}
    z_a, ldj_a = jax_stack(jnp.broadcast_to(a["z0_a"][None], (B, K, 1)),
                           a["r1_a"], a["r2_a"], a["b_a"],
                           compute_log_det=compute_log_det)
    z_r, ldj_r = jax_stack(jnp.broadcast_to(a["z0_r"][None], (B, K, 3)),
                           a["r1_r"], a["r2_r"], a["b_r"],
                           compute_log_det=compute_log_det)
    raw = jnp.concatenate([z_r, z_a], -1).reshape(R, S, K, 4)
    rgb, _, acc, _, depth = jax_raw2outputs(raw, jnp.asarray(z_vals), jnp.asarray(rays_d))
    if compute_log_det:
        ldj_a = ldj_a + (z_a - jax.nn.softplus(z_a)).sum(-1)
        ldj_r = ldj_r + (z_r - 2.0 * jax.nn.softplus(z_r)).sum(-1)
        ldj = jnp.stack([ldj_a.reshape(R, -1).sum(1), ldj_r.reshape(R, -1).sum(1)])
    else:
        ldj = jnp.zeros((2, R))
    return rgb, depth, acc, ldj


def _assert_matches(out, ref, rtol, atol, ldj_rtol):
    for name, a, b in zip(NAMES, out, ref):
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "ldj":
            # per-ray sums over S*K terms of magnitude ~10: relative
            scale = np.maximum(np.abs(b), 1.0)
            np.testing.assert_array_less(np.abs(a - b) / scale, ldj_rtol, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# tolerances mirror tests/test_render_core.py (rtol 2e-5 / atol 2e-4)
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("compute_log_det", [True, False])
def test_plain_matches_jax_kernel(saturate, compute_log_det):
    R, S, K, F = 128, 64, 8, 2
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=0, saturate=saturate)
    ref = jax_fused(*[jnp.asarray(args[k]) for k in ORDER],
                    jnp.asarray(z_vals.ravel()),
                    jnp.asarray(dists_np(z_vals, rays_d).ravel()),
                    S, compute_log_det, True)
    out = fused_flow_composite_plain(*_port_args(args, z_vals, rays_d), S,
                                     compute_log_det)
    _assert_matches(out, ref, rtol=2e-5, atol=2e-4, ldj_rtol=2e-5)
    if not compute_log_det:
        assert float(out[3].abs().max()) == 0.0


@pytest.mark.parametrize("compute_log_det", [True, False])
def test_plain_matches_jax_unfused_where_the_tpu_kernel_cannot_go(compute_log_det):
    # R=100, S=20: no lane-aligned tile, the JAX kernel refuses this shape
    R, S, K, F = 100, 20, 8, 3
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=3, saturate=True)
    ref = _jax_unfused(args, z_vals, rays_d, compute_log_det)
    out = fused_flow_composite(*_port_args(args, z_vals, rays_d), S, compute_log_det)
    _assert_matches(out, ref, rtol=2e-5, atol=2e-4, ldj_rtol=2e-5)


def test_plain_gradients_match_jax_and_stay_finite_at_saturation():
    """The plain version is slice 2's oracle for the backward kernel: its
    autograd gradients (through cumprod) match JAX's, alpha == 1 included.
    rtol 1e-4 / atol 1e-6: the same rule as tests/test_render_core.py's
    gradient checks, at f32."""
    R, S, K, F = 16, 12, 4, 2
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=5, saturate=True)
    w = np.random.RandomState(6).rand(R, 3).astype(np.float32)

    def loss_of(rgb, depth, acc, ldj, target):
        return (((rgb.mean(-1) - target) ** 2).mean()
                + 0.1 * depth.mean() + 0.05 * acc.mean()
                - 0.01 * (ldj[0].sum() + ldj[1].sum()) / (R * S * K))

    jgrad = jax.grad(
        lambda a: loss_of(*_jax_unfused(a, z_vals, rays_d, True), jnp.asarray(w))
    )({k: jnp.asarray(v) for k, v in args.items()})
    targs = {k: torch.as_tensor(v).requires_grad_() for k, v in args.items()}
    out = fused_flow_composite_plain(
        *[targs[k] for k in ORDER], torch.as_tensor(z_vals.ravel()),
        torch.as_tensor(dists_np(z_vals, rays_d).ravel()), S, True)
    loss_of(*out, torch.as_tensor(w)).backward()
    for k in ORDER:
        g = to_np(targs[k].grad)
        assert np.all(np.isfinite(g)), k
        np.testing.assert_allclose(g, np.asarray(jgrad[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _model_like(args):
    """The amortized diagonals are tanh-bounded (flows/amortized.py), so
    |1 + (1 - t^2) r1_ii r2_ii| stays away from 0; raw randn diagonals put
    it near 0 and make the log-det gradient ill-conditioned."""
    args = dict(args)
    for k in ("r1_a", "r2_a"):
        args[k] = np.tanh(args[k])
    for k in ("r1_r", "r2_r"):
        args[k] = args[k].copy()
        for i in range(3):
            args[k][:, i, i] = np.tanh(args[k][:, i, i])
    return args


def _cotangents(R, K, seed):
    """Random cotangents of (rgb, depth, acc, ldj).  The ldj cotangent is
    scaled by 1e-2: in training it is -beta1 / (B K) per ray."""
    rng = np.random.RandomState(seed)
    return [rng.randn(R, 3, K).astype(np.float32), rng.randn(R, K).astype(np.float32),
            rng.randn(R, K).astype(np.float32), (rng.randn(2, R) * 1e-2).astype(np.float32)]


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("compute_log_det", [True, False])
def test_plain_backward_matches_jax_vjp_of_the_kernel(saturate, compute_log_det):
    """The backward kernel's oracle against jax.vjp of cfnerf_tpu's
    fused_flow_composite, whose backward is the Pallas _bwd_kernel (run by
    its interpreter).  JAX returns zeros for z_pts and d_pts; the port's
    autograd Function returns None for them (test below)."""
    R, S, K, F = 128, 64, 8, 2
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=0, saturate=saturate)
    args = _model_like(args)
    inputs = [args[k] for k in ORDER] + [z_vals.ravel(), dists_np(z_vals, rays_d).ravel()]
    cots = _cotangents(R, K, seed=9)
    _, vjp = jax.vjp(lambda *a: jax_fused(*a, S, compute_log_det, True),
                     *[jnp.asarray(a) for a in inputs])
    ref = vjp(tuple(jnp.asarray(c) for c in cots))
    out = fused_flow_composite_bwd_plain([torch.as_tensor(a) for a in inputs],
                                         [torch.as_tensor(c) for c in cots], S,
                                         compute_log_det)
    assert len(out) == 8
    for name, a, b in zip(ORDER, out, ref):
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(to_np(a))), name
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert not np.any(np.asarray(ref[8])) and not np.any(np.asarray(ref[9]))


def test_plain_backward_matches_jax_vjp_past_eight_flow_steps():
    """F = 12, past the 8 steps the backward kernel keeps in registers (its
    generic path recomputes each step's input): the oracle against jax.vjp
    of JAX's kernel, which takes any F, in train mode.  The same rule as
    above."""
    compute_log_det = True
    R, S, K, F = 128, 3, 4, 12
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=21, saturate=True)
    args = _model_like(args)
    inputs = [args[k] for k in ORDER] + [z_vals.ravel(), dists_np(z_vals, rays_d).ravel()]
    cots = _cotangents(R, K, seed=22)
    _, vjp = jax.vjp(lambda *a: jax_fused(*a, S, compute_log_det, True),
                     *[jnp.asarray(a) for a in inputs])
    ref = vjp(tuple(jnp.asarray(c) for c in cots))
    out = fused_flow_composite_bwd_plain([torch.as_tensor(a) for a in inputs],
                                         [torch.as_tensor(c) for c in cots], S,
                                         compute_log_det)
    for name, a, b in zip(ORDER, out, ref):
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(to_np(a))), name
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------- #
# routing: CPU -> plain; CUDA -> kernel or raise; never a quiet fallback
# ---------------------------------------------------------------------- #


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the routing can be
    tested on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _small(R=4, S=5, K=3, F=2):
    args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=1)
    return _port_args(args, z_vals, rays_d), S


def test_cpu_route_is_plain_and_counts_no_launch():
    x, S = _small()
    cots = [torch.as_tensor(c) for c in _cotangents(4, 3, seed=2)]
    before = fused_flow_composite.launches, fused_flow_composite_bwd.launches
    for cld in (True, False):
        out = fused_flow_composite(*x, S, cld)
        ref = fused_flow_composite_plain(*x, S, cld)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        out = fused_flow_composite_bwd(x, cots, S, cld)
        ref = fused_flow_composite_bwd_plain(x, cots, S, cld)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fused_flow_composite.launches, fused_flow_composite_bwd.launches) == before


def test_cuda_route_raises_instead_of_falling_back(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def failed_build(name):
        raise RuntimeError("kernel build failed: simulated")

    monkeypatch.setattr(render_core, "fused_flow_composite_plain", no_plain)
    monkeypatch.setattr(_build, "load", failed_build)
    x, S = _small()
    on_cuda = [t.as_subclass(_OnCuda) for t in x]
    before = fused_flow_composite.launches
    with pytest.raises(RuntimeError, match="build failed"):
        fused_flow_composite(*on_cuda, S, False)
    assert fused_flow_composite.launches == before


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


def test_cuda_route_with_gradients_goes_through_both_kernels(monkeypatch):
    R, S, K, F = 4, 5, 3, 2
    seen = {}

    def fwd(*a):  # outputs: zeros, so the test's loss is well defined
        for ptr, n in zip(a[10:14], (R * 3 * K, R * K, R * K, 2 * R)):
            _floats(ptr, n)[:] = 0.0

    def bwd(*a):
        # cotangents arrive contiguous: rgb and depth from expanded views,
        # acc and ldj (unused) as zeros
        seen["g_rgb"] = _floats(a[10], R * 3 * K).copy()
        seen["g_depth"] = _floats(a[11], R * K).copy()
        seen["g_acc"] = _floats(a[12], R * K).copy()
        seen["g_ldj"] = _floats(a[13], 2 * R).copy()
        seen["ints"] = a[23:28]
        for ptr, x in zip(a[14:22], x_grad):
            _floats(ptr, x.numel())[:] = 7.0

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")

    entries = {"render_core": _Lib(render_core_fwd=_Entry(fwd)),
               "render_core_bwd": _Lib(render_core_bwd=_Entry(bwd))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(render_core, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(render_core, "fused_flow_composite_plain", no_plain)
    monkeypatch.setattr(render_core, "fused_flow_composite_bwd_plain", no_plain)

    x, _ = _small(R, S, K, F)
    x_grad = x[:8]
    on_cuda = [t.as_subclass(_OnCuda).requires_grad_(i < 8 or i == 8)
               for i, t in enumerate(x)]
    before = fused_flow_composite.launches, fused_flow_composite_bwd.launches
    rgb, depth, acc, ldj = fused_flow_composite(*on_cuda, S, True)
    (rgb.mean(-1).sum() + 2.0 * depth.sum()).backward()

    assert fused_flow_composite.launches == before[0] + 1
    assert fused_flow_composite_bwd.launches == before[1] + 1
    assert len(entries["render_core_bwd"].render_core_bwd.calls) == 1
    np.testing.assert_array_equal(seen["g_rgb"], np.full(R * 3 * K, 1.0 / K, np.float32))
    np.testing.assert_array_equal(seen["g_depth"], np.full(R * K, 2.0, np.float32))
    assert not seen["g_acc"].any() and not seen["g_ldj"].any()
    assert seen["ints"] == (R, S, K, F, 1)
    for t in on_cuda[:8]:
        assert t.grad is not None and bool((t.grad == 7.0).all())
    assert on_cuda[8].grad is None  # z_pts: a constant to the kernel's VJP


def _stand_in_entries(monkeypatch, R, S, K, F):
    """Stand-in forward and backward entries that record their calls; the
    forward writes zero outputs, the backward 7.0 into every gradient."""
    def fwd(*a):
        for ptr, n in zip(a[10:14], (R * 3 * K, R * K, R * K, 2 * R)):
            _floats(ptr, n)[:] = 0.0

    def bwd(*a):
        B = R * S
        for ptr, n in zip(a[14:22], (K, B * F, B * F, B * F, 3 * K, 9 * B * F, 9 * B * F,
                                     3 * B * F)):
            _floats(ptr, n)[:] = 7.0

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")

    entries = {"render_core": _Lib(render_core_fwd=_Entry(fwd)),
               "render_core_bwd": _Lib(render_core_bwd=_Entry(bwd))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(render_core, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(render_core, "fused_flow_composite_plain", no_plain)
    monkeypatch.setattr(render_core, "fused_flow_composite_bwd_plain", no_plain)
    return entries


def test_training_past_eight_flow_steps_goes_through_both_kernels(monkeypatch):
    """F = 12 with a gradient on CUDA tensors: `_RenderCore` launches the
    forward and then the backward entry with F = 12, and raises nowhere
    (the backward once refused F > 8 after the forward had run)."""
    R, S, K, F = 3, 4, 2, 12
    entries = _stand_in_entries(monkeypatch, R, S, K, F)
    x, _ = _small(R, S, K, F)
    on_cuda = [t.as_subclass(_OnCuda).requires_grad_(i < 8) for i, t in enumerate(x)]
    before = fused_flow_composite.launches, fused_flow_composite_bwd.launches
    rgb, depth, acc, ldj = fused_flow_composite(*on_cuda, S, True)
    (rgb.sum() + depth.sum() + ldj.sum()).backward()
    assert fused_flow_composite.launches == before[0] + 1
    assert fused_flow_composite_bwd.launches == before[1] + 1
    (fwd_call,) = entries["render_core"].render_core_fwd.calls
    (bwd_call,) = entries["render_core_bwd"].render_core_bwd.calls
    assert fwd_call[14:19] == (R, S, K, F, 1)
    assert bwd_call[23:28] == (R, S, K, F, 1)
    for t in on_cuda[:8]:
        assert t.grad is not None and bool((t.grad == 7.0).all())


def test_more_flow_steps_than_the_forward_stages_raise_before_any_launch(monkeypatch):
    """The one bound on F left is the forward's (one sample a ring stage in
    shared memory); a training call past it raises before the forward
    launches, and the backward entry refuses it too."""
    R, S, K, F = 2, 3, 2, render_core.MAX_F + 1
    entries = _stand_in_entries(monkeypatch, R, S, K, F)
    x, _ = _small(R, S, K, F)
    on_cuda = [t.as_subclass(_OnCuda).requires_grad_(i < 8) for i, t in enumerate(x)]
    before = fused_flow_composite.launches, fused_flow_composite_bwd.launches
    with pytest.raises(ValueError, match=f"at most {render_core.MAX_F}"):
        fused_flow_composite(*on_cuda, S, True)
    cots = [torch.ones(R, 3, K), torch.ones(R, K), torch.ones(R, K), torch.ones(2, R)]
    with pytest.raises(ValueError, match=f"at most {render_core.MAX_F}"):
        fused_flow_composite_bwd([t.detach() for t in on_cuda],
                                 [c.as_subclass(_OnCuda) for c in cots], S, True)
    assert not entries["render_core"].render_core_fwd.calls
    assert not entries["render_core_bwd"].render_core_bwd.calls
    assert (fused_flow_composite.launches, fused_flow_composite_bwd.launches) == before


def test_failed_build_of_the_backward_raises(monkeypatch):
    def load(name):
        if name == "render_core":
            return _Lib(render_core_fwd=_Entry(lambda *a: None))
        raise RuntimeError("kernel build failed: simulated")

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(render_core, "_on_device", lambda dev: _no_cuda_context())
    x, S = _small()
    on_cuda = [t.as_subclass(_OnCuda).requires_grad_(i == 1) for i, t in enumerate(x)]
    before = fused_flow_composite_bwd.launches
    rgb, _, _, _ = fused_flow_composite(*on_cuda, S, True)
    with pytest.raises(RuntimeError, match="build failed"):
        rgb.sum().backward()
    assert fused_flow_composite_bwd.launches == before


def test_other_devices_and_mixed_devices_raise():
    x, S = _small()
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fused_flow_composite(*[t.to("meta") for t in x], S, False)
    mixed = [x[0].as_subclass(_OnCuda)] + x[1:]
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fused_flow_composite(*mixed, S, False)


@pytest.mark.parametrize("bad", ["b_shape", "ragged_rays"])
def test_shape_checks(bad):
    x, S = _small()
    if bad == "b_shape":
        x[3] = x[3][:, :, :1]
    else:
        S = S + 1
    with pytest.raises(ValueError):
        fused_flow_composite(*x, S, False)


def test_any_sample_count_and_single_sample_rays():
    for R, S, K, F in ((3, 1, 2, 1), (7, 13, 33, 3)):
        x, _ = _small(R, S, K, F)
        rgb, depth, acc, ldj = fused_flow_composite(*x, S, True)
        assert rgb.shape == (R, 3, K) and depth.shape == acc.shape == (R, K)
        assert ldj.shape == (2, R)
        assert torch.all(torch.isfinite(ldj)) and torch.all(acc <= 1.0 + 1e-6)


# ---------------------------------------------------------------------- #
# the nvcc build, with a stand-in compiler
# ---------------------------------------------------------------------- #


def _fake_nvcc(tmp_path, ok: bool):
    script = tmp_path / "nvcc"
    calls = tmp_path / "calls"
    body = (
        f'echo call >> "{calls}"\n'
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        + ('echo "ptxas info: 40 registers"; : > "$out"\n' if ok
           else 'echo "error: expected a ;" ; exit 2\n')
    )
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script, calls


def test_build_compiles_once_and_caches_by_source_hash(tmp_path, monkeypatch):
    nvcc, calls = _fake_nvcc(tmp_path, ok=True)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    logs = _build.build(["render_core"])
    assert "registers" in logs["render_core"]
    path = _build.library_path("render_core")
    assert path.exists() and path.parent == tmp_path / "kernels"
    assert path.name.startswith("render_core-") and path.suffix == ".so"
    _build.build(["render_core"])  # cached: no second compile
    assert calls.read_text().count("call") == 1


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, ok=False)
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="expected a ;"):
        _build.build(["render_core"])
    assert not any((tmp_path / "kernels").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setenv("PATH", "")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a system nvcc exists at the fixed fallback path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_source_is_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    src = (_build.CSRC / "render_core.cu").read_text()
    assert 'extern "C" int render_core_fwd' in src
    assert "cfnerf_tpu/ops/pallas/render_core.py:_fwd_kernel" in src
    assert _build.KERNELS[:2] == ("render_core", "render_core_bwd")
    src = (_build.CSRC / "render_core_bwd.cu").read_text()
    assert 'extern "C" int render_core_bwd' in src
    assert "cfnerf_tpu/ops/pallas/render_core.py:_bwd_kernel" in src
