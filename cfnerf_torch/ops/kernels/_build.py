"""Build and load the port's CUDA kernels.

Each source `cfnerf_torch/csrc/<name>.cu` has a plain C interface and is
compiled with nvcc for Hopper into a shared library, then loaded with
ctypes.  Libraries go under `build/kernels/` at the repository root, named by
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused.  Building happens at first use, never at import;
a missing nvcc or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

KERNELS = ("render_core", "render_core_bwd", "flow_stack", "flow_stack_bwd", "trunk",
           "trunk_bwd")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin); the "
        "CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library for `name` lives: hashed over every file in csrc/
    (headers included) and the flags."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*")):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together.  Returns {name: compiler log}; raises
    with the log if any compile fails."""
    logs, todo = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
        else:
            todo[name] = out
    if not todo:
        return logs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"kernel source {src} is missing")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        logs[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
