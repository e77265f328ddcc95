"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to its cell's limit.

Serving: maps_gap, the widest gap over the compared rays of every view
served in the window, between the program's maps and the reference's: the
K draws' rgb, the acc, and the depth over the far bound, each as is.

Training, over the first steps of the step object that the window then
drives (the reference follows them from the same weights, batches and
draws):
  loss_gap    the gap between the program's and the reference's loss at the
              first step (the later steps' losses carry the steps that
              Adam's normalized update makes from near-zero gradient
              entries, and spread from seed to seed: PERF.md, section 2);
  grad_gap    over the leaves, the gap between the norms of the first
              step's gradient (the program's as its Adam state holds it
              after the step: the first moment over 1 - beta1), against the
              reference's norm of that leaf or of the median leaf, whichever
              is larger;
  change_gap  the median leaf's gap between the norms of each leaf's change
              over the steps, against the larger of the reference's change
              of that leaf or of the median leaf; leaves whose reference
              gradient is under a thousandth of the median leaf's are left
              out: Adam moves them by round-off alone.  The median, not the
              worst leaf: the worst is one trunk bias or another, whose
              near-zero gradient entries Adam's normalized step turns into
              steps of the full learning rate either way (PERF.md, section 2).
"""
from __future__ import annotations

from typing import Dict, List

import torch

ADAM_BETA1 = 0.9
NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    p, r = _norms(program), _norms(reference)
    mid = median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], mid, 1e-30)
            for k in r if keep is None or k in keep}


def norm_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keep=None) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(program, reference, keep).values(), default=0.0)


def train_numbers(prog_losses: List[float], prog_first_moment: Dict[str, torch.Tensor],
                  prog_change: Dict[str, torch.Tensor], ref_losses: List[float],
                  ref_grads: Dict[str, torch.Tensor],
                  ref_change: Dict[str, torch.Tensor]) -> Dict[str, float]:
    grads = {k: v / (1.0 - ADAM_BETA1) for k, v in prog_first_moment.items()}
    ref_norms = _norms(ref_grads)
    floor = NEGLIGIBLE_GRAD * median(ref_norms.values())
    moved = {k for k, n in ref_norms.items() if n >= floor}
    return {
        "loss_gap": abs(prog_losses[0] - ref_losses[0]),
        "grad_gap": norm_gap(grads, ref_grads),
        "change_gap": median(leaf_gaps(prog_change, ref_change, keep=moved).values()),
    }


def maps_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             far: float) -> float:
    """The widest gap of one view's compared rays."""
    gaps = [(program["rgb_map"] - reference["rgb_map"]).abs().max(),
            (program["acc_map"] - reference["acc_map"]).abs().max(),
            ((program["depth_map"] - reference["depth_map"]).abs() / far).max()]
    return float(torch.stack(gaps).max())


def path_faults(kernels: Dict[str, bool], launches: Dict[str, int], train: bool,
                counting: bool = True) -> List[str]:
    """What the port's launch counters show off a configuration's path.
    `kernels` names each kernel family (render_core, flow_stack, trunk) the
    path runs (true) or bypasses (false): a bypassed family launches
    nothing; a family on the path launches its forward, and in training its
    backward, where the counters count (on the card: the program's plain
    CPU versions never count)."""
    faults = []
    for family, on in kernels.items():
        for way in ("fwd", "bwd"):
            n = launches.get(f"{family}_{way}", 0)
            if not on and n:
                faults.append(f"{family}_{way} launched {n} times, off the path")
            elif on and counting and (way == "fwd" or train) and not n:
                faults.append(f"{family}_{way} never launched, on the path")
    return faults


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, failed, the compared numbers beside their limits).  A number
    that is missing or not finite fails."""
    compared, failed = {}, 0
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        failed += not ok
        compared[name] = {"value": value, "limit": limit}
    return failed == 0, failed, compared
