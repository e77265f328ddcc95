"""The port stands alone: no module of cfnerf_torch, and not chip_smoke.py,
imports jax or cfnerf_tpu, nor the image, plotting and logging libraries
the port must not need (imageio, Pillow, cv2, matplotlib, tensorboard,
tensorboardX; the card has no imageio and no matplotlib).  The port
reads PNG and JPEG files itself (data/image_io.py, data/jpeg.py); the
logger reaches tensorboard and the video writer imageio only where they
import.
Checked in a fresh interpreter whose import system refuses those names."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cfnerf_tpu", "imageio", "PIL",
           "cv2", "matplotlib", "tensorboard", "tensorboardX")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import cfnerf_torch
names = ["cfnerf_torch"]
for info in pkgutil.walk_packages(cfnerf_torch.__path__, "cfnerf_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module of the port was imported
    assert int(proc.stdout.split()[-1]) >= 56


def test_port_modules_mirror_the_jax_layout():
    port = {p.relative_to(ROOT / "cfnerf_torch").as_posix()
            for p in (ROOT / "cfnerf_torch").rglob("*.py")}
    for mod in ("ops/embed.py", "ops/rays.py", "ops/sampling.py", "ops/compositing.py",
                "ops/metrics.py", "flows/sylvester.py", "flows/amortized.py",
                "models/nerf_flows.py", "models/factory.py", "render/renderer.py",
                "train/loss.py", "train/step.py", "data/sampler.py",
                "ops/occupancy.py", "train/loop.py", "data/poses.py", "data/colmap.py",
                "data/colmap_fused.py", "data/blender.py", "data/llff.py",
                "data/prefetch.py", "utils/config.py", "train/checkpoint.py",
                "train/logging.py", "utils/pointcloud.py", "utils/visualization.py",
                "cli/train.py", "cli/eval.py", "flows/iaf.py", "flows/conv_layers.py",
                "models/nerf.py", "models/baseline_adapter.py", "cli/ensemble.py",
                "parallel/ensemble.py", "parallel/mesh.py"):
        assert mod in port and (ROOT / "cfnerf_tpu" / mod).exists(), mod
    # the port's own modules, with no counterpart in the JAX package: the
    # image codecs that stand in for imageio / Pillow / cv2, the colour maps,
    # the device default
    for mod in ("data/image_io.py", "data/jpeg.py", "utils/colormap.py", "utils/device.py"):
        assert mod in port and not (ROOT / "cfnerf_tpu" / mod).exists(), mod
    # each Pallas kernel module has its wrapper under ops/kernels/
    for mod in ("render_core.py", "flow_stack.py", "trunk.py"):
        assert f"ops/kernels/{mod}" in port, mod
        assert (ROOT / "cfnerf_tpu" / "ops" / "pallas" / mod).exists(), mod
