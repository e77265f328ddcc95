"""The harness finds a cell, a configuration, a traffic mix, a mix's loop,
a family's reference and counts, and a metric that are added as new files
alone, by the names BENCHMARK.json and the files give."""
import json
import shutil
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark with a new cell of a new family, mix kind,
    configuration and metric, each only a new file."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs/cfnerf-flagship.json").read_text())
    config["flags"]["K_samples"] = 16
    config["family"] = "newfamily"
    (b / "configs/new-config.json").write_text(json.dumps(config))
    (b / "reference/newfamily.py").write_text('WHO = "the new family\'s reference"\n')
    (b / "counts/newfamily.py").write_text(
        "def model_ops(flags, n_rays, train):\n    return 7.0 * n_rays\n")
    (b / "cells/newkind.py").write_text("class Cell:\n    KIND = 'newkind'\n")
    mix = json.loads((b / "traffic/serve.json").read_text())
    mix["compared_rays_per_view"] = 7
    mix["kind"] = "newkind"
    (b / "traffic/newmix.json").write_text(json.dumps(mix))
    (b / "workloads/new.cell.json").write_text(json.dumps({"limits": {"maps_gap": 1e-3}}))
    (b / "metrics/new_metric.py").write_text("def read(run):\n    return float(run.window.units)\n")
    bench["configs"].append({"name": "new-config", "source": "https://example.org",
                             "file": "benchmark/configs/new-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new.cell", "config": "new-config",
                               "traffic": "newmix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric.serve.x", "unit": "views", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "serve_rays_per_s", "workloads": ["new.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_rays_per_s":
            m["workloads"].append("new.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_found_by_name(checkout):
    spec = harness.load_spec("new.cell", root=checkout)
    assert spec.flags["K_samples"] == 16
    assert spec.traffic["compared_rays_per_view"] == 7
    assert spec.cell["limits"] == {"maps_gap": 1e-3} and spec.cell["traffic"] == "newmix"
    assert [m["name"] for m in spec.per_layer] == ["new_metric.serve.x"]
    assert {m["name"] for m in spec.end_to_end} == {"serve_rays_per_s", "setup_s"}
    assert spec.reference.WHO == "the new family's reference"
    assert spec.counts.model_ops(spec.flags, 3, False) == 21.0
    assert spec.cell_class().KIND == "newkind"
    run = harness.Run(spec=spec, seed=0, window=harness.Window(durations=[1.0, 2.0]))
    # the name's longest dotted prefix with a file: new_metric.py
    assert harness.load_reader("new_metric.serve.x", checkout).read(run) == 2.0


def test_a_reader_is_the_longest_prefix_with_a_file(checkout):
    (checkout / "benchmark/metrics/new_metric.serve.py").write_text(
        "def read(run):\n    return -1.0\n")
    run = harness.Run(spec=harness.load_spec("new.cell", root=checkout), seed=0)
    assert harness.load_reader("new_metric.serve.x", checkout).read(run) == -1.0
    assert harness.load_reader("new_metric.train", checkout).read(run) == 0.0
    with pytest.raises(FileNotFoundError):
        harness.load_reader("no_such_metric.serve", checkout)


def test_every_metric_and_cell_finds_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read), m["name"]
    for w in bench["workloads"]:
        spec = harness.load_spec(w["name"])
        assert spec.cell["limits"], w["name"]
        assert set(spec.config["kernels"]) == {"render_core", "flow_stack", "trunk"}, w["name"]
        assert callable(spec.reference.make_weights) and callable(spec.counts.model_ops)
        assert spec.cell_class().__module__ == f"benchmark.cells.{spec.traffic['kind']}"
