"""The readings that a cell's limits are set from, on the card at the cell's
own sizes:

  * the program's numbers on many seeds (its first steps, or a few views,
    through the same cell objects a run drives, against the reference);
  * the control's: the reference in TF32, the precision just below the
    configuration's f32 with TF32 off, put in the program's place;
  * for a training cell, the fault "half of the batch left out, the mean
    taken over the rest", planted in the reference put in the program's
    place (the fault "the state left unchanged" reads 1 by change_gap's
    measure and needs no run).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 [--views 3]

One JSON line a seed and reading, then the largest program reading and the
smallest control and fault readings of each number.  The benchmark's runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check, harness, mixes  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402


def half(batch: Dict, draws: Dict, per_ray=("z_vals", "pdf_u")) -> tuple:
    """The first half of the rgb rays and of the depth rays, with their
    draws' rows (the per-ray draws hold the rgb rays, then the depth
    rays)."""
    n_rgb = batch["rays_o"].shape[0]
    n_depth = batch["depth_rays_o"].shape[0] if "depth_rays_o" in batch else 0
    rows = torch.cat([torch.arange(n_rgb // 2), n_rgb + torch.arange(n_depth // 2)])
    b = {k: v[: (n_rgb if k in ("rays_o", "rays_d", "target") else n_depth) // 2]
         for k, v in batch.items()}
    d = {k: (v[rows.to(v.device)] if k in per_ray else v) for k, v in draws.items()}
    return b, d


def worst_leaves(cell, weights, spec, n: int = 3) -> Dict:
    """The look behind a training cell's numbers: the n leaves with the
    widest gradient and change gaps, each with its gap and the reference's
    norms of its gradient and change."""
    cam = mixes.camera(spec.traffic)
    losses, grads, change = spec.reference.train_steps(
        weights, spec.flags, [(c["batch"], c["draws"]) for c in cell.checked],
        cam["near"], cam["far"])
    moment = {k: v / (1.0 - check.ADAM_BETA1) for k, v in cell.first_moment.items()}
    out = {"loss_gap_by_step": [abs(a - b) for a, b in zip(cell.losses, losses)],
           "worst_leaf_change_gap": check.norm_gap(cell.change, change)}
    for name, prog, refs in (("grad", moment, grads), ("change", cell.change, change)):
        gaps = check.leaf_gaps(prog, refs)
        top = sorted(gaps, key=gaps.get, reverse=True)[:n]
        out[name] = [[k, gaps[k], float(grads[k].norm()), float(change[k].norm()),
                      grads[k].numel()] for k in top]
        out[name + "_median_leaf_gap"] = check.median(gaps.values())
    return out


def train_readings(spec, seed: int, device, control: bool, look: bool = False) -> Dict:
    from benchmark import port

    seeds, ref = mixes.sub_seeds(seed, 6), spec.reference
    weights = ref.make_weights(spec.flags, seeds[1], device)
    cell = spec.cell_class()(port, spec, seeds, device, weights)
    cell.warm()
    cell.close()
    out = {"program": cell.numbers(weights)}
    if look:
        out["look"] = worst_leaves(cell, weights, spec)
    if control:
        cam = mixes.camera(spec.traffic)
        steps = [(c["batch"], c["draws"]) for c in cell.checked]
        base = ref.train_steps(weights, spec.flags, steps, cam["near"], cam["far"], "f32")
        halves = [half(*s, per_ray=ref.PER_RAY_DRAWS) for s in steps]
        for name, matmul, feed in (("control", "tf32", steps), ("fault_half_batch", "f32", halves)):
            losses, grads, change = ref.train_steps(weights, spec.flags, feed, cam["near"],
                                                    cam["far"], matmul)
            moment = {k: (1.0 - check.ADAM_BETA1) * g for k, g in grads.items()}
            out[name] = check.train_numbers(losses, moment, change, *base)
    return out


def serve_readings(spec, seed: int, device, control: bool, views: int) -> Dict:
    from benchmark import port

    seeds = mixes.sub_seeds(seed, 6)
    weights = spec.reference.make_weights(spec.flags, seeds[1], device)
    cell = spec.cell_class()(port, spec, seeds, device, weights)
    cell.warm()
    window = harness.Window()
    for _ in range(views):
        cell.unit(Tracer(False), window)
    cell.close()
    out = {"program": cell.numbers(weights)}
    if control:
        worst = 0.0
        for (_, a), (_, b) in zip(cell.reference_maps(weights, "f32"),
                                  cell.reference_maps(weights, "tf32")):
            worst = max(worst, check.maps_gap(b, a, cell.cam["far"]))
        out["control"] = {"maps_gap": worst}
    return out


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--views", type=int, default=2)
    p.add_argument("--look", action="store_true",
                   help="training: also the leaves with the widest gaps")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(a.workload)
    device = torch.device("cuda")
    from benchmark import port

    port.build_kernels()
    worst: Dict[str, Dict[str, float]] = {}
    for seed in list(a.seeds) + [s for s in a.control_seeds if s not in a.seeds]:
        t0 = time.perf_counter()
        control = seed in a.control_seeds
        if spec.train:
            readings = train_readings(spec, seed, device, control, a.look)
        else:
            readings = serve_readings(spec, seed, device, control, a.views)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": a.workload, "seed": seed, **readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for kind, numbers in readings.items():
            if kind == "look":
                continue
            pick = max if kind == "program" else min
            for name, value in numbers.items():
                have = worst.setdefault(kind, {}).get(name)
                worst[kind][name] = value if have is None else pick(have, value)
    print(json.dumps({"workload": a.workload, "largest_program": worst.get("program"),
                      "smallest": {k: v for k, v in worst.items() if k != "program"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
