#!/usr/bin/env python3
"""Time the port's render-core or flow-stack kernels of two checkouts in turns on one card.

    python3 scripts/torch_render_core_times.py --other DIR [--other DIR2 ...]
        [--kernels render_core|flow_stack] [--checks] [--sass OUT]

Each DIR is another checkout of the repository, or a directory holding
only a `cfnerf_torch/` package (e.g. the parent commit unpacked by `git
archive` into a directory that .gitignore lists, or a variant of a kernel).
Each checkout is timed in a process of its own that imports that
checkout's `cfnerf_torch` (its kernels built into its own build/kernels/),
in the order DIR, DIR2, ..., this, this, ..., DIR2, DIR, on the same inputs
as chip_smoke.py's `kernel_time` lines (this checkout's chip_smoke.py, or
DIR's own where DIR's package lacks a name this one imports):

  fwd_serve  the forward at the flagship serving tile (R=8192, S=128, K=32,
             F=4, test mode), 20 launches, inputs larger than the L2;
  fwd_train  the forward at the flagship training tile (R=640, train mode),
             21 launches rotating over three input sets (cold in L2);
  bwd_train  the backward there, 21 launches over three sets.

With --kernels flow_stack it times the flow-stack kernels instead, each
launch of the hierarchical paths at its own shape as chip_smoke.py's
phase_flow_stack_time does (inputs rotating over three sets, cold in L2):

  fwd_serve_{coarse,fine}_{1,3}  the forward's four launches of a
             hierarchical serving tile (test mode, K=32, F=4), 20 each;
  fwd_train_{coarse,fine}_{1,3}  its four launches of a training step
             (train mode), 21 each;
  bwd_train_{coarse,fine}_{1,3}  the backward's four launches of a
             training step, 21 each;
  fwd_tile, fwd_step, bwd_step   the sums of those groups.

Each prints one JSON line per measurement (median ms by CUDA events, the
card's name and power limit); the last line is a summary by checkout.
--checks first runs this checkout's chip_smoke.py checks of those kernels
(against their plain versions at every case).  --sass OUT writes
`cuobjdump -sass` of each checkout's libraries of those kernels to
OUT/<label>_<kernel>.sass.  A checkout whose run fails is reported and left
out of the summary.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def flow_stack_times(cs, flow_stack, label: str, smi: str) -> dict:
    """The flow-stack kernels at the hierarchical paths' launch shapes."""
    import torch

    K, F = cs.HIER["K_samples"], cs.HIER["n_flows"]
    passes = {"serve": (("coarse", cs.SERVE_COARSE_PTS), ("fine", cs.SERVE_FINE_PTS)),
              "train": (("coarse", cs.TRAIN_COARSE_PTS), ("fine", cs.TRAIN_FINE_PTS))}
    res = {}

    def report(what, ms, B, Z, work):
        res[what] = ms
        print(json.dumps({"tree": label, "what": what, "ms": ms, "B": B, "Z": Z,
                          "bound_ms": cs.bound_ms(*work)[0], "nvidia_smi": smi}), flush=True)

    for mode, cld, iters in (("serve", False, 20), ("train", True, 21)):
        for name, B in passes[mode]:
            for Z in (1, 3):
                sets = [(cs.flow_stack_inputs(B, K, Z, F, seed=700 + 7 * j + Z),)
                        for j in range(3)]
                with torch.inference_mode():
                    ms = cs.cuda_ms(lambda x: flow_stack.fused_flow_stack(*x, cld), iters,
                                    sets)
                report(f"fwd_{mode}_{name}_{Z}", ms, B, Z, cs.flow_stack_work(B, K, Z, F, cld))
                del sets
                torch.cuda.empty_cache()
    for name, B in passes["train"]:
        for Z in (1, 3):
            sets = []
            for j in range(3):
                g = torch.Generator(device="cuda").manual_seed(800 + 7 * j + Z)
                sets.append((cs.flow_stack_inputs(B, K, Z, F, seed=900 + 7 * j + Z),
                             [torch.randn(B, K, Z, generator=g, device="cuda"),
                              torch.randn(B, K, generator=g, device="cuda") * 1e-2]))
            ms = cs.cuda_ms(lambda x, c: flow_stack.fused_flow_stack_bwd(x, c, True), 21,
                            sets)
            report(f"bwd_train_{name}_{Z}", ms, B, Z, cs.flow_stack_bwd_work(B, K, Z, F, True))
            del sets
            torch.cuda.empty_cache()
    for total, prefix in (("fwd_tile", "fwd_serve_"), ("fwd_step", "fwd_train_"),
                          ("bwd_step", "bwd_train_")):
        res[total] = sum(v for k, v in res.items() if k.startswith(prefix))
    return res


def worker(tree: Path, label: str, checks: bool, sass: str | None,
           kernels: str = "render_core") -> None:
    sys.path.insert(0, str(tree))
    import importlib.util

    import torch

    # this checkout's chip_smoke.py (inputs, work model, timer, checks), on
    # the other checkout's package when that one is timed; where that package
    # predates a name this chip_smoke.py imports, the other checkout's own
    smokes = [ROOT / "chip_smoke.py"]
    if (tree / "chip_smoke.py").exists() and tree.resolve() != ROOT:
        smokes.append(tree / "chip_smoke.py")
    for i, smoke in enumerate(smokes):
        spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
        cs = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(cs)
            break
        except ImportError:
            if i == len(smokes) - 1:
                raise
    from cfnerf_torch.ops.kernels import _build, flow_stack, render_core

    if not Path(render_core.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"{tree} holds no cfnerf_torch package")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = cs.nvidia_smi_line()
    names = [kernels, f"{kernels}_bwd"]
    logs = _build.build(names)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": label, "build": ptxas, "nvidia_smi": smi,
                      "clocks_sm_now_max": clocks}), flush=True)
    if sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for name in names:
            out = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                                 capture_output=True, text=True, check=True).stdout
            Path(sass, f"{label}_{name}.sass").write_text(out)
    if kernels == "flow_stack":
        if checks:
            cs.phase_flow_stack_checks()
        print(json.dumps({"tree": label, "result": flow_stack_times(cs, flow_stack, label,
                                                                   smi)}), flush=True)
        return
    if checks:
        cs.phase_kernel_checks()
        cs.phase_bwd_checks()

    R, S, K, F = 8192, 128, 32, 4
    x = cs.render_core_inputs(R, S, K, F, seed=7)
    with torch.inference_mode():
        ms = cs.cuda_ms(lambda: render_core.fused_flow_composite(*x, S, False), 20)
    nbytes, ops = cs.render_core_work(R, S, K, F, False)
    res = {"fwd_serve": ms}
    print(json.dumps({"tree": label, "what": "fwd_serve", "ms": ms, "R": R, "S": S,
                      "bound_ms": cs.bound_ms(nbytes, ops)[0], "nvidia_smi": smi}),
          flush=True)
    del x

    R = cs.N_RAND + cs.N_DEPTH
    sets = [(cs.bounded_diagonals(cs.render_core_inputs(R, S, K, F, seed=8 + 2 * i)),
             cs.render_core_cotangents(R, K, seed=9 + 2 * i)) for i in range(3)]
    with torch.inference_mode():
        ms = cs.cuda_ms(lambda x, c: render_core.fused_flow_composite(*x, S, True), 21, sets)
    res["fwd_train"] = ms
    nbytes, ops = cs.render_core_work(R, S, K, F, True)
    print(json.dumps({"tree": label, "what": "fwd_train", "ms": ms, "R": R, "S": S,
                      "bound_ms": cs.bound_ms(nbytes, ops)[0], "nvidia_smi": smi}),
          flush=True)
    ms = cs.cuda_ms(lambda x, c: render_core.fused_flow_composite_bwd(x, c, S, True), 21, sets)
    res["bwd_train"] = ms
    nbytes, ops = cs.render_core_bwd_work(R, S, K, F, True)
    print(json.dumps({"tree": label, "what": "bwd_train", "ms": ms, "R": R, "S": S,
                      "bound_ms": cs.bound_ms(nbytes, ops)[0], "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"tree": label, "result": res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", required=True,
                    help="another checkout's root (repeatable)")
    ap.add_argument("--kernels", choices=("render_core", "flow_stack"), default="render_core")
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(Path(a.worker), a.label, a.checks, a.sass, a.kernels)
        return 0
    if a.sass:
        os.makedirs(a.sass, exist_ok=True)
    trees = {Path(d).resolve().name: Path(d).resolve() for d in a.other}
    order = list(trees) + ["this", "this"] + list(trees)[::-1]
    trees["this"] = ROOT
    results = {label: [] for label in trees}
    failed = False
    for i, label in enumerate(order):
        cmd = [sys.executable, __file__, "--other", a.other[0], "--worker", str(trees[label]),
               "--label", label, "--kernels", a.kernels]
        if a.checks and label == "this" and not results["this"]:
            cmd.append("--checks")
        if a.sass and not results[label]:
            cmd += ["--sass", a.sass]
        out = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(json.dumps({"tree": label, "run": i, "failed": out.returncode}), flush=True)
            failed = True
            continue
        last = json.loads(out.stdout.strip().splitlines()[-1])
        results[label].append(last["result"])
    summary = {label: {k: [r[k] for r in rs] for k in rs[0]}
               for label, rs in results.items() if rs}
    print(json.dumps({"summary": summary,
                      "median": {label: {k: statistics.median(v) for k, v in d.items()}
                                 for label, d in summary.items()}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
