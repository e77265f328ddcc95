"""Checkpoint / resume; counterpart of cfnerf_tpu/train/checkpoint.py, with
its semantics (the reference's .tar checkpointing,
run_nerf_uncertainty_NF.py:1085-1100 save, :345-374 load):

  * directory layout basedir/dataname/type_flows/expname/ (:349);
  * name pattern {step:06d}_{ensemble:02d} (:1086), a directory per
    checkpoint as the JAX package writes it, so the same pattern and
    --ft_path find either; inside it one torch.save file, STATE_FILE;
  * auto-resume from the newest checkpoint of this ensemble member in the
    run dir, or from --index_step / --ft_path (:351-355);
  * params are the state dicts of the coarse net and, where there is one,
    the fine net ({"coarse": ..., "fine": ...}), the test-mode eps buffers
    included; they are merged with a FILTERED update: entries absent from
    the current model are dropped, entries missing from the checkpoint or of
    another shape keep their fresh init (:363-374);
  * the optimizer's state_dict is saved but deliberately NOT restored
    (:360-361).

The file holds only tensors and plain Python containers and scalars, so it
loads with torch.load(weights_only=True).
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Mapping, Optional, Tuple

import torch

# 6+ digits: {step:06d} grows past 6 digits for steps >= 1M and those
# checkpoints must still be found by auto-resume
_CKPT_RE = re.compile(r"^(\d{6,})_(\d{2})$")
STATE_FILE = "state.pt"


def run_dir(basedir: str, dataname: str, type_flows: str, expname: str) -> str:
    return os.path.join(basedir, dataname, type_flows, expname)


def checkpoint_path(rundir: str, step: int, ensemble: int = 1) -> str:
    return os.path.join(rundir, f"{step:06d}_{ensemble:02d}")


def list_checkpoints(rundir: str) -> List[Tuple[int, int, str]]:
    """[(step, ensemble, path)] sorted by step."""
    if not os.path.isdir(rundir):
        return []
    out = []
    for name in sorted(os.listdir(rundir)):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), os.path.join(rundir, name)))
    return sorted(out)


def save_checkpoint(rundir: str, step: int, params: Mapping[str, Mapping[str, torch.Tensor]],
                    opt_state: Optional[Mapping] = None, ensemble: int = 1) -> str:
    """Write {global_step, params, opt_state} to checkpoint_path(rundir, step,
    ensemble)/STATE_FILE and return the checkpoint's directory.  params:
    {"coarse": state_dict[, "fine": state_dict]}; opt_state: an optimizer's
    state_dict (or None)."""
    path = checkpoint_path(rundir, step, ensemble)
    os.makedirs(path, exist_ok=True)
    state = {
        "global_step": int(step),
        "params": params,
        "opt_state": opt_state if opt_state is not None else {},
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # never a half-written file
    return path


def _filtered_merge(fresh: Any, loaded: Any) -> Any:
    """Reference-style tolerant merge: use loaded entries where the key path
    and shape match the fresh init (cast to its dtype and device); keep
    fresh entries otherwise."""
    if isinstance(fresh, Mapping):
        return {k: _filtered_merge(v, loaded[k]) if isinstance(loaded, Mapping)
                and k in loaded else v for k, v in fresh.items()}
    if isinstance(loaded, torch.Tensor) and loaded.shape == fresh.shape:
        return loaded.to(dtype=fresh.dtype, device=fresh.device)
    return fresh


def restore_checkpoint(path: str, fresh_params: Mapping) -> Tuple[dict, int]:
    """Restore params (filtered-merged into fresh_params, the same
    {"coarse", "fine"} layout of state dicts) and global_step.  The
    optimizer state is intentionally not returned (reference :360-361)."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(
            f"{path} holds no {STATE_FILE}: not a checkpoint of the port (a JAX "
            "checkpoint converts with scripts/jax_checkpoint_to_torch.py)")
    raw = torch.load(file, map_location="cpu", weights_only=True)
    step = int(raw.get("global_step", 0))
    return _filtered_merge(fresh_params, raw.get("params", {})), step


def find_resume_checkpoint(
    rundir: str,
    *,
    ft_path: Optional[str] = None,
    index_step: int = -1,
    ensemble: int = 1,
) -> Optional[str]:
    """Resolve which checkpoint to resume from (reference :346-355)."""
    if ft_path and ft_path != "None":
        return ft_path
    # only this ensemble member's checkpoints: the reference scans all of
    # them (:349), so later members silently resume from earlier ones
    ckpts = [c for c in list_checkpoints(rundir) if c[1] == ensemble]
    if not ckpts:
        return None
    if index_step == -1:
        return ckpts[-1][2]
    want = checkpoint_path(rundir, index_step, ensemble)
    return want if os.path.exists(want) else None
