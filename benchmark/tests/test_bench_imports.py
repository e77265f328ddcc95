"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares each loaded module's top-level name whole (cfnerf_torch begins
with cfnerf_t, as cfnerf_tpu does), and the reference imports nothing of
the program."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
                 "cfnerf_tpu", "cfnerf_tpu.models.nerf_flows"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jaxfoo", "flaxen", "cfnerf_torch_extra", "optaxes"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == sorted(
        ["cfnerf_tpu", "cfnerf_tpu.models.nerf_flows", "flax.linen", "jax", "jax.numpy",
         "jaxlib.xla_client", "optax"])


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path))
        assert not found & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "cfnerf_torch" not in found and "benchmark" not in found - {"benchmark"}, path
            assert found <= {"__future__", "contextlib", "math", "dataclasses", "typing",
                             "numpy", "torch"}, (path, found)


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from benchmark import harness; from benchmark.tests.helpers import tiny_spec; "
            "r = harness.run_cell(tiny_spec('hier.train'), 1, 0.05, False, 'cpu', "
            "time.perf_counter()); print(r['correct'], harness.forbidden_modules())"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"
