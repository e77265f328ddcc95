"""The trunk backward: its plain version against jax.vjp of cfnerf_tpu's
pallas_encode (the Pallas kernels run through their interpreter on the CPU);
`_Trunk`'s routing, with stand-in kernel entries; one flat and one
hierarchical training step of trunk_impl="interpret" models against JAX's
make_train_step; the golden
file that lets chip_smoke.py hold the card's backward kernels against JAX's
gradients.

The CUDA kernels cannot run here (no card, no nvcc): chip_smoke.py holds
them against the plain version on the H100.

Gate.  Each gradient leaf (a weight or a bias of one nn.Linear) is judged
as tests/test_pallas_trunk.py judges JAX's kernel: relative RMS error
<= 2e-3 and cosine >= 0.9999.  Both sides round the same values to bf16 and
sum exact f32 products in another order, so an activation now and then
rounds to the neighbouring bf16 value; measured <= 2.6e-4 here.  A relu
input within one rounding of 0 would take the other branch on one side and
move a whole row's contribution (~1/B of a gradient): the seeds below have
none.  Autograd of the plain forward rounds the weight gradients to bf16
and takes f32 products of f32 cotangents: it misses the gate (5.4e-3 to
7.2e-3), which is the fault `_Trunk` repairs.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_trunk_bwd
(test_trunk_grad_golden_is_current fails while the committed file is stale).
"""
import ctypes
import dataclasses
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.trunk import pallas_encode
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.ops.kernels import _build, trunk
from cfnerf_torch.ops.kernels.trunk import (
    pack_trunk_weights,
    trunk_encode,
    trunk_encode_bwd,
    trunk_encode_bwd_plain,
    trunk_encode_plain,
)
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np
from tests.test_torch_trunk import (
    GOLDEN, _Entry, _no_cuda_context, _no_plain, _on_cuda, _OnCuda)
from tests.test_torch_train import (
    METRICS,
    TRAIN_KW,
    _grads_in_opt_state,
    _port_names,
    assert_params_after_update_close,
    jax_draws,
    make_batch,
    port_grads,
)

GRAD_GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_trunk_grad_golden.npz"
REL_RMS, MIN_COS = 2e-3, 0.9999
IN_CH, V_CH = 63, 27
SMALL = Tiny(depth=4, width=256, k=8, flows=2, h_alpha=64, h_rgb=64)
WIDE = Tiny(depth=8, width=512, k=4, flows=2, h_alpha=64, h_rgb=64)
# the port's modules of the trunk (pallas_encode's params subtree)
TRUNK_MODULES = ("pts_linears", "feature_linear", "views_linear", "h_alpha_linear",
                 "h_rgb_linear")
T = torch.as_tensor


@functools.lru_cache(maxsize=None)
def _jax(cfg: Tiny, seed: int = 0):
    return jax_nerf_flows(cfg, seed, trunk_impl="interpret")


def _trunk_names(depth):
    return [f"pts_linear_{i}" for i in range(depth)] + [
        "feature_linear", "views_linear", "h_alpha_linear", "h_rgb_linear"]


def _inputs(B, seed, stride=IN_CH + V_CH):
    """x (B, 90), as the first 90 columns of a (B, stride) array when
    stride > 90, and the two heads' cotangents."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, stride).astype(np.float32)
    return x, rng.randn(B, 64).astype(np.float32), rng.randn(B, 64).astype(np.float32)


def jax_trunk_grads(cfg: Tiny, params, x, g_ha, g_hr):
    """jax.vjp of pallas_encode(interpret=True) with the given cotangents,
    under the port's parameter names (trunk parameters only)."""
    tp = {n: params[n] for n in _trunk_names(cfg.depth)}

    def f(p):
        return pallas_encode(p, jnp.asarray(x[:, :IN_CH + V_CH]), depth=cfg.depth,
                             width=cfg.width, input_ch=IN_CH, views_ch=V_CH, interpret=True)

    _, vjp = jax.vjp(f, tp)
    (g,) = vjp((jnp.asarray(g_ha), jnp.asarray(g_hr)))
    # converted beside the other parameters, then only the trunk's kept
    full = {**params, **jax.tree_util.tree_map(np.asarray, g)}
    return {k: v.numpy() for k, v in nerf_flows_state_dict_from_jax(full).items()
            if k.split(".")[0] in TRUNK_MODULES}


def _model(cfg: Tiny, trunk_impl="interpret", seed=0):
    _, params, eps = _jax(cfg, seed)
    return port_nerf_flows(cfg, params, eps, trunk_impl=trunk_impl)


def _x_tensor(x):
    """x's first 90 columns as a strided view when it is wider."""
    return T(x)[:, :IN_CH + V_CH]


def leaf_errors(grads, ref):
    """name -> (relative RMS error, cosine) for every leaf of `ref`."""
    out = {}
    for name, r in ref.items():
        g = np.asarray(grads[name], np.float64)
        r = np.asarray(r, np.float64)
        rms = np.sqrt(np.mean((g - r) ** 2)) / max(np.sqrt(np.mean(r ** 2)), 1e-30)
        cos = float((g * r).sum() / max(np.linalg.norm(g) * np.linalg.norm(r), 1e-30))
        out[name] = (float(rms), cos)
    return out


def _failing(errs):
    """The leaves past the gate; a leaf that is zero on both sides (the
    density flow's amor_d, which feeds only the strictly upper triangle of a
    1x1 matrix) passes."""
    return {k: v for k, v in errs.items()
            if not (v[0] <= REL_RMS and (v[1] >= MIN_COS or v == (0.0, 0.0)))}


def _model_grads(model, x, g_ha, g_hr, encode):
    model.zero_grad(set_to_none=True)
    ha, hr = encode(model, _x_tensor(x))
    torch.autograd.backward([ha, hr], [T(g_ha), T(g_hr)])
    return {n: to_np(p.grad) for n, p in model.named_parameters() if p.grad is not None}


def _through_autograd(model, x):
    return trunk_encode_plain(pack_trunk_weights(model), x)


# ---------------------------------------------------------------------- #
# the plain backward against jax.vjp of pallas_encode
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("cfg,B,seed,stride", [
    (SMALL, 300, 300, 90),
    (WIDE, 77, 78, 90),
    (SMALL, 130, 5, 96),
], ids=["D4W256_B300", "D8W512_ragged_B77", "D4W256_strided_x"])
def test_plain_backward_matches_jax_vjp(cfg, B, seed, stride):
    """Through the model (pack, `_Trunk` with the plain route, the packing's
    adjoint back to the nn.Linear leaves) against JAX's custom VJP; and
    autograd of the plain forward on the same inputs misses the gate."""
    _, params, _ = _jax(cfg)
    x, g_ha, g_hr = _inputs(B, seed, stride)
    ref = jax_trunk_grads(cfg, params, x, g_ha, g_hr)
    model = _model(cfg)
    grads = _model_grads(model, x, g_ha, g_hr, lambda m, xt: m.encode(xt))
    assert set(grads) == set(ref)
    assert not _failing(leaf_errors(grads, ref))
    autograd = _model_grads(_model(cfg), x, g_ha, g_hr, _through_autograd)
    assert _failing(leaf_errors(autograd, ref))


def test_backward_entry_is_plain_on_the_cpu():
    """trunk_encode_bwd on CPU tensors is the plain version, counts no
    launch, and lays its output out as the packed buffers; an unused head
    (None) counts as a zero cotangent."""
    model = _model(SMALL)
    x, g_ha, g_hr = _inputs(40, 9)
    with torch.no_grad():
        packed = pack_trunk_weights(model)
        before = trunk_encode_bwd.launches
        dw, db = trunk_encode_bwd(packed, T(x), T(g_ha), None)
        want = trunk_encode_bwd_plain(packed, T(x), T(g_ha), torch.zeros(40, 64))
    assert trunk_encode_bwd.launches == before
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == packed.w.shape and db.shape == packed.b.shape
    torch.testing.assert_close(dw, want[0], rtol=0, atol=0)
    torch.testing.assert_close(db, want[1], rtol=0, atol=0)
    # the k-step padding of w0 / wsx / wvv gets a zero gradient
    m = trunk._split_mats(dw, packed._shape())
    assert not m["w0"][:, IN_CH:].any() and not m["wvv"][:, V_CH:].any()


def test_weight_gradients_reach_the_linear_layers_in_f32():
    """The packed weights enter `_Trunk` in f32, so autograd does not round
    their gradients to bf16 on the way to the nn.Linear leaves."""
    model = _model(SMALL)
    x, g_ha, g_hr = _inputs(64, 10)
    grads = _model_grads(model, x, g_ha, g_hr, lambda m, xt: m.encode(xt))
    w = model.pts_linears[1].weight.grad
    assert w.dtype == torch.float32
    assert not torch.equal(w, w.bfloat16().float())
    assert set(grads) == {n for n, _ in model.named_parameters()
                          if n.split(".")[0] in TRUNK_MODULES}


# ---------------------------------------------------------------------- #
# routing: a CUDA gradient launches forward then backward kernel
# ---------------------------------------------------------------------- #


def _fill(ptr, n, value):
    np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))[:] = value


GRAD_VALUE = 1.2345678  # not a bf16 value: bf16 would make it 1.234375
ACTS_BYTES = 4096  # what the stand-in trunk_fwd_workspace announces


def _stand_ins(monkeypatch, bwd_lib=None):
    """Stand-in forward (serving and training) and backward entries; the
    backward fills dw with GRAD_VALUE and db with 0.5.  Returns (training
    forward entry, backward entry); the serving entry and the two size
    entries are on the returned entries' `.lib` namespaces."""
    packed = _packed()

    def fwd_body(*a):  # emb, stride, w, b, h_alpha, h_rgb, B, ...
        _fill(a[4], a[6] * a[11], 1.5)
        _fill(a[5], a[6] * a[12], 1.5)

    def save_body(*a):  # emb, stride, w, b, h_alpha, h_rgb, acts, acts_bytes, B, ...
        _fill(a[4], a[8] * a[13], 1.5)
        _fill(a[5], a[8] * a[14], 1.5)

    def bwd_body(*a):  # acts, acts_bytes, w, g_ha, g_hr, dw, db, ws, ws_bytes, B, ...
        _fill(a[5], packed.w.numel(), GRAD_VALUE)
        _fill(a[6], packed.b.numel(), 0.5)

    fwd, save, bwd = _Entry(fwd_body), _Entry(save_body), _Entry(bwd_body)
    fwd_lib = types.SimpleNamespace(trunk_fwd=fwd, trunk_fwd_save=save,
                                    trunk_fwd_workspace=_Entry(lambda *a: None, ret=ACTS_BYTES))
    bwd_ns = types.SimpleNamespace(trunk_bwd=bwd,
                                   trunk_bwd_workspace=_Entry(lambda *a: None, ret=256))
    save.lib, bwd.lib = fwd_lib, bwd_ns
    libs = {trunk.NAME: fwd_lib, trunk.NAME_BWD: bwd_lib or bwd_ns}

    def load(name):
        lib = libs[name]
        if isinstance(lib, Exception):
            raise lib
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(trunk, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(trunk, "trunk_encode_plain", _no_plain)
    monkeypatch.setattr(trunk, "trunk_encode_bwd_plain", _no_plain)
    return save, bwd


def _packed(cfg=SMALL):
    with torch.no_grad():
        return pack_trunk_weights(_model(cfg))


def _cuda_leaves():
    """The packed f32 weights and biases as CUDA-reporting leaves that
    require grad, and x."""
    packed = _packed()
    w = packed.w.clone().as_subclass(_OnCuda).requires_grad_()
    b = packed.b.clone().as_subclass(_OnCuda).requires_grad_()
    x = T(_inputs(10, 8)[0]).as_subclass(_OnCuda).requires_grad_()
    return dataclasses.replace(packed, w=w, b=b), x


def test_cuda_gradient_launches_forward_then_backward(monkeypatch):
    """One forward (the training variant) and one backward launch,
    counted; the weight gradient arrives as the backward kernel wrote it, in
    f32; x gets none."""
    fwd, bwd = _stand_ins(monkeypatch)
    packed, x = _cuda_leaves()
    before = trunk_encode.launches, trunk_encode_bwd.launches
    ha, hr = trunk_encode(packed, x)
    assert (trunk_encode.launches, trunk_encode_bwd.launches) == (before[0] + 1, before[1])
    assert len(fwd.calls) == 1 and not bwd.calls and not fwd.lib.trunk_fwd.calls
    g = torch.ones(10, 64).as_subclass(_OnCuda)
    torch.autograd.backward([ha, hr], [g, g])
    assert (trunk_encode.launches, trunk_encode_bwd.launches) == (before[0] + 1, before[1] + 1)
    call = bwd.calls[0]
    assert call[8] == 256 and call[9:16] == (10, 4, 256, IN_CH, V_CH, 64, 64)
    assert packed.w.grad.dtype == torch.float32
    assert bool((packed.w.grad == torch.tensor(GRAD_VALUE)).all())
    assert bool((packed.b.grad == 0.5).all())
    assert x.grad is None


def test_cuda_gradient_of_one_head_sends_a_zero_cotangent(monkeypatch):
    """An unused head's cotangent arrives as None (set_materialize_grads
    False); the backward kernel is handed zeros for it."""
    seen = []
    _, bwd = _stand_ins(monkeypatch)
    real = bwd.body
    bwd.body = lambda *a: (seen.append(np.ctypeslib.as_array(
        (ctypes.c_float * (10 * 64)).from_address(a[4])).copy()), real(*a))
    packed, x = _cuda_leaves()
    ha, _ = trunk_encode(packed, x)
    ha.backward(torch.ones(10, 64).as_subclass(_OnCuda))
    assert len(seen) == 1 and not seen[0].any()


@pytest.mark.parametrize("failing", ["forward", "backward"])
def test_a_failed_build_raises_instead_of_falling_back(monkeypatch, failing):
    lib = RuntimeError("kernel build failed: simulated")
    _stand_ins(monkeypatch, bwd_lib=lib if failing == "backward" else None)
    if failing == "forward":
        monkeypatch.setattr(_build, "load", lambda name: (_ for _ in ()).throw(lib))
    packed, x = _cuda_leaves()
    before = trunk_encode_bwd.launches
    with pytest.raises(RuntimeError, match="build failed"):
        ha, hr = trunk_encode(packed, x)
        g = torch.ones(10, 64).as_subclass(_OnCuda)
        torch.autograd.backward([ha, hr], [g, g])
    assert trunk_encode_bwd.launches == before
    assert packed.w.grad is None


def test_backward_kernel_refuses_what_it_cannot_take(monkeypatch):
    """The standalone entry checks x, the weights and the cotangents
    before it launches anything (the training forward comes first)."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no launch expected"))
    packed = _on_cuda(_packed())
    x = T(_inputs(4, 3)[0])
    g = torch.zeros(4, 64).as_subclass(_OnCuda)
    with pytest.raises(ValueError, match="contiguous"):
        trunk_encode_bwd(packed, x.t().contiguous().t().as_subclass(_OnCuda), g, g)
    with pytest.raises(ValueError, match="cotangent of h_rgb"):
        trunk_encode_bwd(packed, x.as_subclass(_OnCuda), g, torch.zeros(4, 48).as_subclass(_OnCuda))
    with pytest.raises(ValueError, match="float32"):
        trunk_encode_bwd(dataclasses.replace(packed, w=packed.w.double()),
                         x.as_subclass(_OnCuda), g, g)


def test_training_forward_saves_the_workspace_the_backward_reads(monkeypatch):
    """On the kernel route a forward with a gradient launches the training
    variant with a workspace of the size trunk_fwd_workspace announces; the
    backward gets that same memory and its size, and no embedding: it does
    not recompute the forward."""
    save, bwd = _stand_ins(monkeypatch)
    packed, x = _cuda_leaves()
    ha, hr = trunk_encode(packed, x)
    assert save.lib.trunk_fwd_workspace.calls == [(10, 4, 256, IN_CH, V_CH)]
    (call,) = save.calls
    assert call[0] == x.data_ptr() and call[7] == ACTS_BYTES
    assert call[8:15] == (10, 4, 256, IN_CH, V_CH, 64, 64)
    g = torch.ones(10, 64).as_subclass(_OnCuda)
    torch.autograd.backward([ha, hr], [g, g])
    (bcall,) = bwd.calls
    assert bcall[:2] == (call[6], ACTS_BYTES)
    assert x.data_ptr() not in bcall


def test_serving_forward_allocates_no_workspace(monkeypatch):
    """Under no_grad the route launches the serving kernel and asks for no
    workspace."""
    save, _ = _stand_ins(monkeypatch)
    packed, x = _cuda_leaves()
    before = trunk_encode.launches
    with torch.no_grad():
        trunk_encode(packed, x)
    assert trunk_encode.launches == before + 1
    assert len(save.lib.trunk_fwd.calls) == 1
    assert not save.calls and not save.lib.trunk_fwd_workspace.calls


def test_standalone_backward_launches_training_forward_then_backward(monkeypatch):
    """trunk_encode_bwd on CUDA tensors: the training forward into a new
    workspace, then the backward on it; one launch counted on each."""
    save, bwd = _stand_ins(monkeypatch)
    packed, x = _cuda_leaves()
    g = torch.ones(10, 64).as_subclass(_OnCuda)
    before = trunk_encode.launches, trunk_encode_bwd.launches
    with torch.no_grad():
        dw, db = trunk_encode_bwd(packed, x, g, None)
    assert (trunk_encode.launches, trunk_encode_bwd.launches) == (before[0] + 1, before[1] + 1)
    (call,), (bcall,) = save.calls, bwd.calls
    assert bcall[:2] == (call[6], ACTS_BYTES)
    assert bool((dw == torch.tensor(GRAD_VALUE)).all()) and bool((db == 0.5).all())


def test_backward_kernel_source_is_built_for_hopper():
    assert "trunk_bwd" in _build.KERNELS
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    src = (_build.CSRC / "trunk_bwd.cu").read_text()
    assert 'extern "C" int trunk_bwd' in src and 'extern "C" long long trunk_bwd_workspace' in src
    fwd = (_build.CSRC / "trunk.cu").read_text()
    assert 'extern "C" int trunk_fwd_save' in fwd
    assert 'extern "C" long long trunk_fwd_workspace' in fwd
    # both read the saved activations' layout from the shared header
    assert "struct ActPlan" in (_build.CSRC / "trunk.cuh").read_text()
    for name in ("_bwd_top_kernel", "_bwd_bottom_kernel"):
        assert f"cfnerf_tpu/ops/pallas/trunk.py:{name}" in src.replace("\n//", "")
    # both passes run wgmma: the data pass with A loaded by ldmatrix and B by
    # TMA, the weight-gradient pass on TMA-loaded, mbarrier-completed tiles;
    # the Hopper pieces come from hopper.cuh, which the forward includes too
    header = (_build.CSRC / "trunk.cuh").read_text()
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src and '#include "trunk.cuh"' in src
    assert '#include "hopper.cuh"' in fwd
    for text in (src, header, fwd, hopper):
        assert "wmma::" not in text
    assert "layer(" not in src and "ldmatrix" in src
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "__grid_constant__ WgradParams", "cuTensorMapEncodeTiled"):
        assert ptx in src + hopper, ptx
    for call in ("wgmma_tt<", "wgmma_m64n64k16_rt(", "tma_load(", "mbar_wait(", "encode_map("):
        assert call in src, call
    assert "atomicAdd" not in src  # fixed-order sums: deterministic
    # the backward reads the training forward's activations: it stages no
    # embedding and takes none
    assert "stage_inputs" not in src and "const float* emb" not in src
    assert trunk.REPLACES_BWD == ("cfnerf_tpu/ops/pallas/trunk.py:170",
                                  "cfnerf_tpu/ops/pallas/trunk.py:229")


# ---------------------------------------------------------------------- #
# the slice end to end: a training step against JAX's
# ---------------------------------------------------------------------- #


STEP_REL_RMS = 1e-2


def test_interpret_trunk_training_step_matches_jax(monkeypatch):
    """One flat step of D4/W256 trunk_impl="interpret" models: the port's
    make_train_step (the render core's plain version, `_Trunk` on the plain
    route) against JAX's (pallas_encode's custom VJP in interpret mode),
    with JAX's draws.

    Tolerances: loss and metrics rtol 1e-4 (the bf16 trunk's outputs sit up
    to ~4e-4 apart, see tests/test_torch_trunk.py; measured <= 1.8e-7).
    The gradients reaching the trunk differ by ~1e-4 (measured <= 3.1e-4
    relative RMS at the flows), and every bf16 rounding on the way down
    turns such a difference into a whole bf16 step for the elements near a
    rounding boundary, so the trunk's leaves sit further apart at the step
    than at the trunk alone: every leaf relative RMS <= 1e-2 and cosine
    >= 0.9999 (measured <= 3.6e-3).  On the step's own cotangents the
    trunk's gradients meet the tight gate against jax.vjp.  The weights
    after one Adam step as tests/test_torch_train.py judges them."""
    jm, params, test_eps = _jax(SMALL)
    n_rgb, n_depth, n_samples = 24, 8, 16
    batch = make_batch(n_rgb, n_depth, seed=3)
    key = jax.random.PRNGKey(7)
    cfg = jstep.TrainConfig(**TRAIN_KW)
    rc = jrender.RenderConfig(n_samples=n_samples, perturb=True, use_viewdirs=True, fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    new_params, state, jmetrics = step(p, tx.init(p), batch, key)
    jgrads, jafter = _port_names(state[0]), _port_names(new_params)
    t_rand, eps = jax_draws(key, n_rgb + n_depth, n_samples, SMALL.k)

    seen = {}
    real = trunk._Trunk.backward

    def backward(ctx, g_ha, g_hr):  # keeps the step's trunk input and cotangents
        seen.update(x=ctx.saved_tensors[0].numpy().copy(), g_ha=g_ha.numpy().copy(),
                    g_hr=g_hr.numpy().copy())
        return real(ctx, g_ha, g_hr)

    monkeypatch.setattr(trunk._Trunk, "backward", staticmethod(backward))
    model = port_nerf_flows(SMALL, params, test_eps, trunk_impl="interpret")
    pstep, tm, tg = port_grads(model, batch, t_rand, eps, n_samples)
    assert set(tm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jmetrics[k]), rtol=1e-4, err_msg=k)
    assert set(tg) == set(jgrads)
    errs = leaf_errors(tg, jgrads)
    assert not {k: v for k, v in errs.items()
                if not (v[0] <= STEP_REL_RMS and (v[1] >= MIN_COS or v == (0.0, 0.0)))}
    on_own = jax_trunk_grads(SMALL, params, seen["x"], seen["g_ha"], seen["g_hr"])
    assert not _failing(leaf_errors(tg, on_own))
    pstep.update()
    assert_params_after_update_close(model, jafter, jgrads, TRAIN_KW["lrate"])


HIER_STEP_REL_RMS = 2e-2


def test_interpret_trunk_hierarchical_step_matches_jax(monkeypatch):
    """One hierarchical step of a D4/W256 trunk_impl="interpret" pair (16 +
    8 samples) against JAX's make_train_step(model_fine=...) with
    interpreted trunks, with JAX's draws (tests/test_torch_hierarchical.py).
    Tolerances as in the flat step, but every leaf relative RMS <= 2e-2
    (measured <= 8.1e-3): the fine pass's samples are resampled from the
    coarse weights, so the forwards' small differences also move the fine
    net's inputs.  On each net's own cotangents the trunk's gradients meet
    the tight gate against jax.vjp."""
    from tests.test_torch_hierarchical import (
        N_IMPORTANCE, N_SAMPLES, RAYS, _port_draws, jax_draws as hier_draws)
    from tests.test_torch_hierarchical import TRAIN_KW as HIER_KW
    from cfnerf_torch.convert import nerf_flows_pair_state_dicts_from_jax
    from cfnerf_torch.models.nerf_flows import NeRFFlows
    from cfnerf_torch.render.renderer import RenderConfig
    from cfnerf_torch.train.step import TrainConfig, make_train_step

    jm, pc, ec = _jax(SMALL, 0)
    jmf, pf, ef = _jax(SMALL, 1)
    params = {"coarse": pc, "fine": pf}
    batch = make_batch(*RAYS, seed=6)
    key = jax.random.PRNGKey(11)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=True,
                              use_viewdirs=True)
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, jstep.TrainConfig(**HIER_KW), model_fine=jmf)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    new_params, state, jmetrics = step(p, tx.init(p), batch, key)
    sides = ("coarse", "fine")
    jgrads = {side: _port_names(state[0][side]) for side in sides}
    jafter = {side: _port_names(new_params[side]) for side in sides}

    seen = {}
    real = trunk._Trunk.backward

    def backward(ctx, g_ha, g_hr):  # each net's trunk input and cotangents, by row count
        x = ctx.saved_tensors[0]
        seen[x.shape[0]] = (x.numpy().copy(), g_ha.numpy().copy(), g_hr.numpy().copy())
        return real(ctx, g_ha, g_hr)

    monkeypatch.setattr(trunk._Trunk, "backward", staticmethod(backward))
    models = []
    for state_dict in nerf_flows_pair_state_dicts_from_jax(params, ec, ef):
        net = NeRFFlows(net_depth=SMALL.depth, net_width=SMALL.width, skips=(SMALL.depth // 2,),
                        h_alpha_size=SMALL.h_alpha, h_rgb_size=SMALL.h_rgb,
                        n_flows=SMALL.flows, k_samples=SMALL.k, trunk_impl="interpret")
        net.load_state_dict(state_dict)
        models.append(net)
    pstep, _ = make_train_step(models[0], RenderConfig(n_samples=N_SAMPLES,
                                                       n_importance=N_IMPORTANCE),
                               TrainConfig(**HIER_KW), model_fine=models[1])
    loss, metrics = pstep.loss_fn(batch, None, **_port_draws(hier_draws(key, sum(RAYS),
                                                                        SMALL.k)))
    loss.backward()
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    rows = {"coarse": sum(RAYS) * N_SAMPLES, "fine": sum(RAYS) * (N_SAMPLES + N_IMPORTANCE)}
    for side, net in zip(sides, models):
        grads = {n: to_np(q.grad) for n, q in net.named_parameters() if q.grad is not None}
        errs = leaf_errors(grads, jgrads[side])
        assert not {k: v for k, v in errs.items()
                    if not (v[0] <= HIER_STEP_REL_RMS
                            and (v[1] >= MIN_COS or v == (0.0, 0.0)))}, side
        own = jax_trunk_grads(SMALL, params[side], *seen[rows[side]])
        assert not _failing(leaf_errors(grads, own)), side
    pstep.update()
    for side, net in zip(sides, models):
        assert_params_after_update_close(net, jafter[side], jgrads[side], HIER_KW["lrate"])


# ---------------------------------------------------------------------- #
# golden for the card: JAX's trunk gradients on the D4/W256 trunk of
# tests/fixtures/torch_port_trunk_golden.npz
# ---------------------------------------------------------------------- #


def trunk_grad_golden_arrays():
    """The cotangents of the trunk golden's x and JAX's gradients (under
    the port's names); the weights are the trunk golden's."""
    _, params, _ = _jax(Tiny(depth=4, width=256, k=4, flows=2, h_alpha=64, h_rgb=64))
    with np.load(Path(__file__).parent / "fixtures" / "torch_port_trunk_golden.npz") as g:
        x = g["x"]
    rng = np.random.RandomState(12)
    g_ha = rng.randn(x.shape[0], 64).astype(np.float32)
    g_hr = rng.randn(x.shape[0], 64).astype(np.float32)
    arrays = {"g/h_alpha": g_ha, "g/h_rgb": g_hr}
    cfg = Tiny(depth=4, width=256, k=4, flows=2, h_alpha=64, h_rgb=64)
    for name, v in jax_trunk_grads(cfg, params, x, g_ha, g_hr).items():
        arrays[f"jax/grad/{name}"] = v
    return arrays


def save_trunk_grad_golden():
    np.savez_compressed(GRAD_GOLDEN, **trunk_grad_golden_arrays())


def test_trunk_grad_golden_is_current():
    assert GRAD_GOLDEN.exists(), "run: python -m tests.test_torch_trunk_bwd"
    assert GRAD_GOLDEN.stat().st_size < 2 << 20
    fresh = trunk_grad_golden_arrays()
    with np.load(GRAD_GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith("jax/"):
                # the margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_trunk_grad_golden_through_the_plain_version():
    """What chip_smoke.py does on the card, here through the plain version:
    the trunk golden's model, x and these cotangents through `_Trunk`."""
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    with np.load(GRAD_GOLDEN) as f:
        gg = {k: f[k] for k in f.files}
    D, Wd, K, F, ha, hr = (int(v) for v in g["config"])
    params = {}
    for k, v in g.items():
        if k.startswith("p/"):
            node = params
            *parents, leaf = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    model = port_nerf_flows(Tiny(depth=D, width=Wd, k=K, flows=F, h_alpha=ha, h_rgb=hr),
                            params, (g["test_eps_a"], g["test_eps_r"]), trunk_impl="pallas")
    grads = _model_grads(model, g["x"], gg["g/h_alpha"], gg["g/h_rgb"],
                         lambda m, xt: m.encode(xt))
    ref = {k[len("jax/grad/"):]: v for k, v in gg.items() if k.startswith("jax/grad/")}
    assert set(grads) == set(ref)
    assert not _failing(leaf_errors(grads, ref))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_trunk_grad_golden()
    print(f"wrote {GRAD_GOLDEN} ({GRAD_GOLDEN.stat().st_size} bytes)")
