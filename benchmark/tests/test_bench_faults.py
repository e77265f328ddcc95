"""Each fault a cell can have, planted under the harness's timed path at a
tiny size on the CPU, turns `correct` false: the whole run but the look for
a card."""
import time
import types

import pytest
import torch

from benchmark import check, harness, port
from benchmark.tests.helpers import tiny_spec


def planted(**overrides):
    return types.SimpleNamespace(**{**{k: getattr(port, k) for k in dir(port)
                                       if not k.startswith("_")}, **overrides})


def state_unchanged():
    def train_step(*args):
        step, optimizer = port.train_step(*args)
        optimizer.step = lambda *a, **k: None
        return step, optimizer
    return planted(train_step=train_step)


def half_batch():
    def call_step(step, item):
        b, d = item["batch"], item["draws"]
        n_rgb = b["rays_o"].shape[0]
        n_depth = b["depth_rays_o"].shape[0] if "depth_rays_o" in b else 0
        rows = torch.cat([torch.arange(n_rgb // 2), n_rgb + torch.arange(n_depth // 2)])
        batch = {k: v[: (n_rgb if k in ("rays_o", "rays_d", "target") else n_depth) // 2]
                 for k, v in b.items()}
        draws = {k: v[rows] if k in ("z_vals", "pdf_u") else v for k, v in d.items()}
        return port.call_step(step, {"batch": batch, "draws": draws})
    return planted(call_step=call_step)


def answer_altered():
    def view_renderer(*args):
        render, warm = port.view_renderer(*args)

        def altered(c2w):
            maps = render(c2w)
            rgb = maps["rgb_map"].clone()
            rgb.view(-1, *rgb.shape[2:])[:64] += 1e-2  # one tile's answers
            return dict(maps, rgb_map=rgb)
        return altered, warm
    return planted(view_renderer=view_renderer)


def flow_stack_launched():
    """A port whose counters show the flow stack on the fused path: one
    launch more at each reading."""
    calls = []

    def launches():
        calls.append(1)
        out = port.launches()
        out["flow_stack_fwd"] += len(calls)
        return out
    return planted(launches=launches)


@pytest.mark.parametrize("workload", ["flagship.train", "flagship.serve"])
def test_a_cell_off_its_path_is_caught(workload):
    result = harness.run_cell(tiny_spec(workload), 12, 0.05, False, "cpu", time.perf_counter(),
                              port=flow_stack_launched())
    assert result["left_path"] == ["flow_stack_fwd launched 1 times, off the path"]


def test_path_faults_by_counter():
    on = {"render_core": True, "flow_stack": False, "trunk": False}
    assert check.path_faults(on, {"render_core_fwd": 3, "render_core_bwd": 3}, True) == []
    assert check.path_faults(on, {"render_core_fwd": 3}, False) == []
    assert check.path_faults(on, {"render_core_fwd": 3}, True) == [
        "render_core_bwd never launched, on the path"]
    assert check.path_faults(on, {}, True, counting=False) == []
    assert check.path_faults(on, {"render_core_fwd": 1, "trunk_bwd": 2}, False) == [
        "trunk_bwd launched 2 times, off the path"]


@pytest.mark.parametrize("workload,fault", [
    ("flagship.train", state_unchanged), ("flagship.train", half_batch),
    ("hier.train", state_unchanged), ("hier.train", half_batch),
    ("flagship.serve", answer_altered), ("hier.serve", answer_altered)])
def test_fault_is_not_correct(workload, fault):
    result = harness.run_cell(tiny_spec(workload), 11, 0.1, False, "cpu", time.perf_counter(),
                              port=fault())
    assert not result["correct"], result["compared"]
    assert result["failed"] >= 1
