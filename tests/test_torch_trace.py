"""The program's spans and counters (cfnerf_torch/utils/trace.py): nothing
recorded without a profile; under torch.profiler on the CPU the aggregate's
calls, total, self and max, each span a host event of the profiler's on its
clock, a worker thread's spans kept under that thread; the prefetcher's
feed.empty; no span or count lost across many threads; the training
step's four phases, flat and hierarchical, with the loss bitwise the same
under the profiler; one render.tile a tile."""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfnerf_torch.data.prefetch import BatchPrefetcher
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.render.renderer import make_render_rays, render_image
from cfnerf_torch.train.step import TrainConfig, make_train_step
from cfnerf_torch.utils import trace
from cfnerf_torch.utils.config import parse_args

PHASES = ["cfnerf.train.zero_grad", "cfnerf.train.forward", "cfnerf.train.backward",
          "cfnerf.train.update"]
FLAGS = ["--model", "NeRF_Flows", "--type_flows", "triangular", "--netdepth", "2",
         "--netwidth", "16", "--N_samples", "6", "--K_samples", "3", "--n_flows", "2",
         "--h_alpha_size", "8", "--h_rgb_size", "8", "--n_hidden", "8", "--multires", "2",
         "--multires_views", "1", "--use_viewdirs", "--no_ndc", "--N_rand", "8"]
HIER = ["--N_importance", "6", "--netdepth_fine", "2", "--netwidth_fine", "16"]


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def recorded(fn, **kwargs):
    """fn() under torch.profiler on the CPU; (its result, the profiler's
    host events by name, the window's start and end ns)."""
    with profile(activities=[ProfilerActivity.CPU], **kwargs) as prof:
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    return out, events, t0, t1


def test_without_a_profile_nothing_is_recorded():
    assert not trace.recording()
    s = trace.span("cfnerf.x")
    assert s is trace.span("cfnerf.y", step=3) is trace._NULL
    with s:
        trace.count("feed.empty")
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["threads"] == {} and snap["counters"] == {}
    assert set(snap["launches"]) == {"render_core_fwd", "render_core_bwd", "flow_stack_fwd",
                                     "flow_stack_bwd", "trunk_fwd", "trunk_bwd"}


def test_nested_spans_give_calls_total_self_max_and_host_events():
    def work():
        assert trace.recording()
        for pause in (0.004, 0.001):
            with trace.span("cfnerf.a"):
                time.sleep(pause)
                with trace.span("cfnerf.b", step=7):
                    time.sleep(0.002)
        trace.count("feed.empty", 2)

    _, events, t0, t1 = recorded(work, record_shapes=True)
    snap = trace.snapshot()
    a, b = snap["spans"]["cfnerf.a"], snap["spans"]["cfnerf.b"]
    assert a["calls"] == b["calls"] == 2
    assert b["self_ns"] == b["total_ns"] >= 4_000_000
    assert a["self_ns"] == a["total_ns"] - b["total_ns"] >= 5_000_000
    assert a["max_ns"] >= 6_000_000 and a["max_ns"] <= a["total_ns"] - 3_000_000
    assert b["max_ns"] <= b["total_ns"]
    assert snap["threads"] == {threading.current_thread().name: snap["spans"]}
    assert snap["counters"] == {"feed.empty": 2}
    # each span is a host event of the profiler's on the Unix ns clock,
    # nested as the spans are, carrying its step
    outer, inner = events["cfnerf.a"], events["cfnerf.b"]
    assert len(outer) == len(inner) == 2
    for ea, eb in zip(sorted(outer, key=lambda e: e.start_ns()),
                      sorted(inner, key=lambda e: e.start_ns())):
        assert t0 <= ea.start_ns() < eb.start_ns() < eb.end_ns() < ea.end_ns() <= t1
        assert ea.start_thread_id() == eb.start_thread_id()
        assert eb.kwinputs() == {"step": 7}
    assert not trace.recording()


def test_a_span_on_another_thread_is_kept_under_that_thread():
    def worker():
        with trace.span("cfnerf.w"):
            time.sleep(0.001)

    def work():
        t = threading.Thread(target=worker, name="cfnerf.test_worker")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with trace.span("cfnerf.m"):
            pass

    recorded(work)
    threads = trace.snapshot()["threads"]
    assert set(threads["cfnerf.test_worker"]) == {"cfnerf.w"}
    assert set(threads[threading.current_thread().name]) == {"cfnerf.m"}


def test_many_threads_lose_no_span_and_no_count():
    n_threads, n = 16, 300
    go = threading.Barrier(n_threads + 1)

    def worker():
        go.wait(timeout=10)
        for _ in range(n):
            with trace.span("cfnerf.s"):
                trace.count("c")

    def work():
        threads = [threading.Thread(target=worker, name=f"cfnerf.t{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        go.wait(timeout=10)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        recorded(work)
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    assert snap["spans"]["cfnerf.s"]["calls"] == n_threads * n
    assert snap["counters"]["c"] == n_threads * n
    assert all(snap["threads"][f"cfnerf.t{i}"]["cfnerf.s"]["calls"] == n
               for i in range(n_threads))


@pytest.mark.parametrize("slow", [True, False])
def test_prefetcher_counts_the_nexts_that_found_no_batch(slow):
    def make(step):
        if slow:
            time.sleep(0.05)
        return {"x": np.full(2, step)}

    def take():
        # the worker starts inside the profile's window
        pf = BatchPrefetcher(make, start_step=0, device="cpu")
        try:
            steps = [pf.next()[0]]  # the first finds nothing when make is slow
            first = trace.snapshot()["counters"].get("feed.empty", 0)
            for _ in range(4):
                if not slow:
                    time.sleep(0.01)  # the worker refills meanwhile
                steps.append(pf.next()[0])
            return steps, first
        finally:
            pf.close()

    (steps, first), events, _, _ = recorded(take)
    snap = trace.snapshot()
    assert steps == [1, 2, 3, 4, 5]
    assert snap["spans"]["cfnerf.feed.next"]["calls"] == len(events["cfnerf.feed.next"]) == 5
    if slow:
        assert first == 1 and snap["counters"]["feed.empty"] == 5
    else:
        assert snap["counters"].get("feed.empty", 0) == first <= 1
    assert "cfnerf.feed.make" in snap["threads"]["cfnerf.feed"]


def _step(hier: bool, profiled: bool):
    args = parse_args(FLAGS + (HIER if hier else []))
    model, fine, rc = build_model(args, device="cpu")
    cfg = TrainConfig(H=6, W=5, focal=4.0, ndc=False, near=2.0, far=6.0, k_samples=3)
    step, _ = make_train_step(model, rc, cfg, model_fine=fine)
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randn(8, 3, generator=g) for k in ("rays_o", "rays_d", "target")}

    def run():
        return step(batch, torch.Generator().manual_seed(11))

    return recorded(run) if profiled else (run(), None, None, None)


@pytest.mark.parametrize("hier", [False, True])
def test_the_step_records_its_four_phases_in_order(hier):
    metrics, events, _, _ = _step(hier, True)
    snap = trace.snapshot()
    assert {n: s["calls"] for n, s in snap["spans"].items()} == {p: 1 for p in PHASES}
    starts = [events[p][0].start_ns() for p in PHASES]
    ends = [events[p][0].end_ns() for p in PHASES]
    assert all(e <= s for e, s in zip(ends, starts[1:])), (starts, ends)
    plain, _, _, _ = _step(hier, False)
    assert torch.equal(metrics["loss"], plain["loss"])


def test_render_image_records_a_tile_span_a_tile():
    args = parse_args(FLAGS)
    model, _, rc = build_model(args, device="cpu")
    render_rays = make_render_rays(model, rc)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0

    def render():
        return render_image(render_rays, c2w, H=4, W=5, focal=4.0, ndc=False,
                            use_viewdirs=True, near=2.0, far=6.0, tile=8, device="cpu")

    maps, events, _, _ = recorded(render)
    assert maps["rgb_map"].shape[:2] == (4, 5)
    calls = {n: s["calls"] for n, s in trace.snapshot()["spans"].items()}
    assert calls == {"cfnerf.render.rays": 1, "cfnerf.render.tile": 3,  # 20 rays, 8 a tile
                     "cfnerf.render.gather": 1}
    assert len(events["cfnerf.render.tile"]) == 3
