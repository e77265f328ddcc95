"""Weights carried across from the JAX package.

`nerf_flows_state_dict_from_jax` turns a cfnerf_tpu NeRFFlows params pytree
(nested dicts of numpy arrays) into a state_dict for
cfnerf_torch.models.nerf_flows.NeRFFlows of the family `type_flows`.  A
gradient pytree of the same layout maps the same way, onto the port's
parameter names.

  * Dense layers: flax kernels are (in, out), torch weights (out, in).  The
    JAX side computes the skip and views concatenations as split matmuls
    over one kernel; the port concatenates the same parts in the same order
    and applies one nn.Linear, so the kernel converts as it is.
  * Base parameters alpha_mean/alpha_std/rgb_mean/rgb_std copy over.
  * The amortizers flows_alpha / flows_rgb by family: triangular amor_d,
    amor_diag1, amor_diag2, amor_b; householder and orthogonal the same and
    amor_q; planar amor_u, amor_w, amor_b; IAF ctx_proj and flow_{k}'s
    z_feats, mean, std (MADE kernels unmasked, as JAX stores them); no_flow
    none (JAX's pytree has no flows_*).
  * test_eps=(eps_a (K, 1), eps_r (K, 3)) fills the fixed test-mode eps
    buffers (the JAX model's `_test_eps`, last draw already zeroed).  Without
    it the dict holds no buffers; load it with strict=False to keep the
    model's own.

`nerf_flows_pair_state_dicts_from_jax` does the same for a hierarchical
{"coarse", "fine"} params pair (cfnerf_tpu/models/factory.py:create_nerf),
giving the state dicts of the coarse and the fine network.

`baseline_state_dict_from_jax` does it for a KSampleBaseline
(cfnerf_tpu/models/baseline_adapter.py): base/trunk/pts_linear_{i} ->
base.trunk.pts_linears.{i}, and the heads alpha_linear, feature_linear,
views_linear, rgb_linear, std_linear, output_linear where present;
nerf_wild's test_eps (K, 3), JAX's jax.random.normal(PRNGKey(seed), (K, 3)),
fills its buffer with the last draw zeroed, as the model uses it.
`state_dict_from_jax(params, model=, type_flows=, test_eps=)` picks the map
from the --model and --type_flows flags.

`proposal_state_dict_from_jax` turns a cfnerf_tpu ProposalMLP params dict
({"w0", "b0", ...}, w{i} (d_in, d_out); keys starting "__" are metadata and
skipped) into a state_dict for cfnerf_torch.ops.occupancy.ProposalMLP
(layers.{i}.weight (d_out, d_in), layers.{i}.bias).
scripts/jax_checkpoint_to_torch.py reads a JAX Orbax checkpoint (Orbax
imports jax, so not here) and writes it through these maps as the port's
checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_HEADS = ("feature_linear", "views_linear", "h_alpha_linear", "h_rgb_linear")
_TRIANGULAR = ("amor_d", "amor_diag1", "amor_diag2", "amor_b")
_AMOR = {
    "triangular": _TRIANGULAR,
    "householder": _TRIANGULAR + ("amor_q",),
    "orthogonal": _TRIANGULAR + ("amor_q",),
    "planar": ("amor_u", "amor_w", "amor_b"),
    "no_flow": (),
}
_IAF_STEP = ("z_feats", "mean", "std")
_BASELINE_HEADS = ("alpha_linear", "feature_linear", "views_linear", "rgb_linear",
                   "std_linear", "output_linear")
_BASELINES = ("nerf", "nerf_dropout", "nerf_wild")
_BASE = ("alpha_mean", "alpha_std", "rgb_mean", "rgb_std")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _amortizer(sd: Dict[str, torch.Tensor], fam: str, p: Mapping[str, Any],
               type_flows: str) -> None:
    if type_flows == "IAF":
        _dense(sd, f"{fam}.ctx_proj", p["ctx_proj"])
        k = 0
        while f"flow_{k}" in p:
            for name in _IAF_STEP:
                _dense(sd, f"{fam}.flow_{k}.{name}", p[f"flow_{k}"][name])
            k += 1
        return
    if type_flows not in _AMOR:
        raise ValueError(f"no flow family {type_flows!r} to convert")
    for name in _AMOR[type_flows]:
        _dense(sd, f"{fam}.{name}", p[name])


def nerf_flows_state_dict_from_jax(
    params: Mapping[str, Any],
    test_eps: Optional[Tuple[Any, Any]] = None,
    type_flows: str = "triangular",
) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"pts_linear_{i}" in params:
        _dense(sd, f"pts_linears.{i}", params[f"pts_linear_{i}"])
        i += 1
    for name in _HEADS:
        if name in params:
            _dense(sd, name, params[name])
    for fam in ("flows_alpha", "flows_rgb"):
        if type_flows != "no_flow":
            _amortizer(sd, fam, params[fam], type_flows)
    for name in _BASE:
        sd[name] = _t(params[name])
    if test_eps is not None:
        sd["test_eps_a"] = _t(test_eps[0])
        sd["test_eps_r"] = _t(test_eps[1])
    return sd


def nerf_flows_pair_state_dicts_from_jax(
    params: Mapping[str, Any],
    test_eps: Optional[Tuple[Any, Any]] = None,
    test_eps_fine: Optional[Tuple[Any, Any]] = None,
    type_flows: str = "triangular",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(coarse, fine) state dicts from a {"coarse", "fine"} pytree; each
    network's test eps as in `nerf_flows_state_dict_from_jax`."""
    return (nerf_flows_state_dict_from_jax(params["coarse"], test_eps, type_flows),
            nerf_flows_state_dict_from_jax(params["fine"], test_eps_fine, type_flows))


def baseline_state_dict_from_jax(
    params: Mapping[str, Any],
    test_eps: Optional[Any] = None,
) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    base = params["base"]
    i = 0
    while f"pts_linear_{i}" in base["trunk"]:
        _dense(sd, f"base.trunk.pts_linears.{i}", base["trunk"][f"pts_linear_{i}"])
        i += 1
    for name in _BASELINE_HEADS:
        if name in base:
            _dense(sd, f"base.{name}", base[name])
    if test_eps is not None:
        eps = _t(test_eps)
        eps[-1] = 0.0
        sd["test_eps"] = eps
    return sd


def state_dict_from_jax(
    params: Mapping[str, Any],
    model: Optional[str] = None,
    type_flows: str = "triangular",
    test_eps: Optional[Any] = None,
) -> Dict[str, torch.Tensor]:
    """The map for the --model / --type_flows flags: a baseline's
    (`model` nerf, nerf_dropout or nerf_wild; test_eps nerf_wild's (K, 3))
    or NeRFFlows' of the family `type_flows` (model None, 'nerf_flows' or
    'NeRF_Flows'; test_eps (eps_a, eps_r))."""
    name = (model or "nerf_flows").lower()
    if name in _BASELINES:
        return baseline_state_dict_from_jax(params, test_eps)
    if name != "nerf_flows":
        raise ValueError(f"no model {model!r} to convert")
    return nerf_flows_state_dict_from_jax(params, test_eps, type_flows)


def proposal_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"w{i}" in params:
        sd[f"layers.{i}.weight"] = _t(params[f"w{i}"]).T.contiguous()
        sd[f"layers.{i}.bias"] = _t(params[f"b{i}"])
        i += 1
    return sd
