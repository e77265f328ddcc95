"""The trunk's domain: trunk_impl="interpret" takes what JAX's Pallas trunk
takes (cfnerf_tpu/ops/pallas/trunk.py:supported: widths W and W / 2 in
whole 128-lane tiles, any depth >= 3, any head widths), beyond the trunk
kernels' own limits (W <= 512, heads in whole 16-column tiles), and
trunk_impl="pallas" refuses what the kernels cannot take before any launch.

The plain forward and backward of a D4/W768 trunk and of a trunk whose
heads are not a multiple of 16 wide, through the model, against
pallas_encode(interpret=True) and jax.vjp of it, at the tolerances of
tests/test_torch_trunk.py (h_alpha / h_rgb atol 1e-3 / rtol 1e-2) and
tests/test_torch_trunk_bwd.py (per leaf relative RMS 2e-3, cosine 0.9999).
"""
import numpy as np
import pytest
import torch

from cfnerf_torch.models.nerf_flows import NeRFFlows, interpret_supported
from cfnerf_torch.ops.kernels import _build, trunk
from cfnerf_torch.ops.kernels.trunk import pack_trunk_weights, supported, trunk_encode
from tests.test_torch_common import Tiny
from tests.test_torch_trunk import _assert_enc_close, _jax, _model, _no_plain, _on_cuda, _OnCuda
from tests.test_torch_trunk import jax_encode
from tests.test_torch_trunk_bwd import (
    IN_CH,
    V_CH,
    _failing,
    _model_grads,
    jax_trunk_grads,
    leaf_errors,
)

T = torch.as_tensor
W768 = Tiny(depth=4, width=768, k=4, flows=2, h_alpha=64, h_rgb=64)
ODD_HEADS = Tiny(depth=4, width=256, k=4, flows=2, h_alpha=24, h_rgb=40)


def _inputs(cfg: Tiny, B: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, IN_CH + V_CH).astype(np.float32),
            rng.randn(B, cfg.h_alpha).astype(np.float32),
            rng.randn(B, cfg.h_rgb).astype(np.float32))


@pytest.mark.parametrize("cfg", [W768, ODD_HEADS], ids=["D4W768", "heads24_40"])
def test_interpret_trunk_matches_jax_outside_the_kernels_domain(cfg):
    """Forward and one gradient of a trunk_impl="interpret" model that the
    kernels cannot take, against JAX's interpreted Pallas trunk."""
    assert not supported(cfg.depth, cfg.width, True, (cfg.depth // 2,), cfg.h_alpha,
                         cfg.h_rgb, IN_CH, V_CH)
    assert interpret_supported(cfg.depth, cfg.width, True, (cfg.depth // 2,))
    _, params, _ = _jax(cfg)
    x, g_ha, g_hr = _inputs(cfg, 77, seed=cfg.width + cfg.h_alpha)
    model = _model(cfg, "interpret")
    with torch.no_grad():
        out = model.encode(T(x))
    _assert_enc_close(out, jax_encode(cfg, params, x))
    ref = jax_trunk_grads(cfg, params, x, g_ha, g_hr)
    grads = _model_grads(model, x, g_ha, g_hr, lambda m, xt: m.encode(xt))
    assert set(grads) == set(ref)
    assert not _failing(leaf_errors(grads, ref))


def test_interpret_domain_is_jax_rule():
    assert interpret_supported(8, 512, True, (4,))
    assert interpret_supported(8, 1024, True, (4,))
    assert interpret_supported(3, 768, True, (1,))
    assert not interpret_supported(8, 384, True, (4,))  # W / 2 = 192: not whole lanes
    assert not interpret_supported(8, 128, True, (4,))
    assert not interpret_supported(2, 512, True, (1,))
    assert not interpret_supported(8, 512, False, (4,))
    assert not interpret_supported(8, 512, True, (3,))


@pytest.mark.parametrize("over", [dict(net_width=768), dict(net_width=1024),
                                  dict(h_alpha_size=24, h_rgb_size=40)],
                         ids=["width768", "width1024", "heads24_40"])
def test_pallas_refuses_what_the_kernels_cannot_take(monkeypatch, over):
    """Outside the kernels' domain trunk_impl="pallas" raises ValueError at
    construction and trunk_encode refuses the packed weights on a CUDA
    tensor, both before any build or launch; "interpret" takes them."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no launch expected"))
    kw = {**dict(net_depth=4, net_width=256, input_ch=IN_CH, input_ch_views=V_CH,
                 skips=(2,), h_alpha_size=64, h_rgb_size=64, n_flows=2, k_samples=4), **over}
    with pytest.raises(ValueError, match="trunk_impl='pallas'"):
        NeRFFlows(**kw, trunk_impl="pallas")
    model = NeRFFlows(**kw, trunk_impl="interpret")
    monkeypatch.setattr(trunk, "trunk_encode_plain", _no_plain)
    with torch.no_grad():
        packed = _on_cuda(pack_trunk_weights(model))
    x = torch.zeros(5, IN_CH + V_CH).as_subclass(_OnCuda)
    before = trunk_encode.launches
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported shape"):
        trunk_encode(packed, x)
    assert trunk_encode.launches == before
