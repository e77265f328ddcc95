"""Weights carried across from the JAX package.

`nerf_flows_state_dict_from_jax` turns a cfnerf_tpu NeRFFlows params pytree
(nested dicts of numpy arrays) into a state_dict for
cfnerf_torch.models.nerf_flows.NeRFFlows.  A gradient pytree of the same
layout maps the same way, onto the port's parameter names.

  * Dense layers: flax kernels are (in, out), torch weights (out, in).  The
    JAX side computes the skip and views concatenations as split matmuls
    over one kernel; the port concatenates the same parts in the same order
    and applies one nn.Linear, so the kernel converts as it is.
  * Base parameters alpha_mean/alpha_std/rgb_mean/rgb_std copy over.
  * test_eps=(eps_a (K, 1), eps_r (K, 3)) fills the fixed test-mode eps
    buffers (the JAX model's `_test_eps`, last draw already zeroed).  Without
    it the dict holds no buffers; load it with strict=False to keep the
    model's own.

`nerf_flows_pair_state_dicts_from_jax` does the same for a hierarchical
{"coarse", "fine"} params pair (cfnerf_tpu/models/factory.py:create_nerf),
giving the state dicts of the coarse and the fine network.

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
_AMOR = ("amor_d", "amor_diag1", "amor_diag2", "amor_b")
_BASE = ("alpha_mean", "alpha_std", "rgb_mean", "rgb_std")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(p["bias"])


def nerf_flows_state_dict_from_jax(
    params: Mapping[str, Any],
    test_eps: Optional[Tuple[Any, Any]] = None,
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
        for name in _AMOR:
            _dense(sd, f"{fam}.{name}", params[fam][name])
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
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(coarse, fine) state dicts from a {"coarse", "fine"} pytree; each
    network's test eps as in `nerf_flows_state_dict_from_jax`."""
    return (nerf_flows_state_dict_from_jax(params["coarse"], test_eps),
            nerf_flows_state_dict_from_jax(params["fine"], test_eps_fine))


def proposal_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"w{i}" in params:
        sd[f"layers.{i}.weight"] = _t(params[f"w{i}"]).T.contiguous()
        sd[f"layers.{i}.bias"] = _t(params[f"b{i}"])
        i += 1
    return sd
