"""The training loop's stage schedules; counterpart of the schedule helpers of
cfnerf_tpu/train/loop.py (:54-113), with the same errors and messages.  The
loop itself (`train`) comes with slice 6b.

  * --k_schedule 'K:step,...': a piecewise-constant K over global steps
    (parse_k_schedule, k_for_step).  K is no parameter axis, so weights and
    optimizer state carry across stages;
  * --occ_floor_anneal: the placement floor of the occ stage, linear from
    --occ_floor_start at the stage boundary to --occ_floor
    (occ_floor_for_step), fed to the step as batch["occ_floor"].
"""
from __future__ import annotations

from typing import List, Tuple


def parse_k_schedule(spec: str) -> List[Tuple[int, int]]:
    """Parse 'K:step,K:step,...' (e.g. '8:0,16:2000,32:5000') into a sorted
    [(start_step, K), ...].  Raises ValueError for a malformed item, a
    duplicate start step, no stage at step 0, or a K below 2 (the KDE
    bandwidth needs two draws)."""
    stages = []
    for part in spec.split(","):
        try:
            k_str, step_str = part.split(":")
            stages.append((int(step_str), int(k_str)))
        except ValueError:
            raise ValueError(
                f"bad --k_schedule entry {part!r}; expected 'K:start_step' "
                "items, e.g. '8:0,16:2000,32:5000'"
            )
    stages.sort()
    starts = [s for s, _ in stages]
    if len(set(starts)) != len(starts):
        # a tuple sort would let the larger K win a duplicated start silently
        dup = sorted({s for s in starts if starts.count(s) > 1})
        raise ValueError(
            f"--k_schedule has duplicate start_step value(s) {dup}; each "
            "stage must begin at a distinct step"
        )
    if stages[0][0] != 0:
        raise ValueError("--k_schedule must define a stage starting at step 0")
    if any(k < 2 for _, k in stages):
        raise ValueError("--k_schedule K values must be >= 2 (KDE needs "
                         "multiple samples for its bandwidth)")
    return stages


def k_for_step(stages: List[Tuple[int, int]], step: int) -> int:
    """K of the last stage that starts at or before `step`."""
    k = stages[0][1]
    for s, kk in stages:
        if step >= s:
            k = kk
    return k


def occ_floor_for_step(step: int, occ_from: int, anneal: int,
                       floor_start: float, floor_end: float) -> float:
    """Linear placement floor of the occ stage: floor_start at the boundary
    `occ_from`, floor_end once `anneal` steps have passed, clamped on both
    sides; floor_end when anneal <= 0.  Indexed by global step, so a resumed
    run lands at the right point."""
    if anneal <= 0:
        return floor_end
    t = min(max((step - occ_from) / anneal, 0.0), 1.0)
    return floor_start + (floor_end - floor_start) * t
