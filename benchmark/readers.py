"""What the metric readers (benchmark/metrics/<metric>.py) share: the work
of a step, a view and a kernel launch from the family's counts
(benchmark/counts/<family>.py), and the traced groups' device seconds.

Host-clock readings come from the run's untraced window (`run.window`),
device readings from the traced one (`run.traced`, `run.trace`), so that
the profiler's cost on the host never enters a host-clock metric."""
from __future__ import annotations

from typing import Optional

from benchmark.counts import work


def model_ops_per_unit(run) -> float:
    """The model's operations of one step (forward and backward) or one
    view (its pixels' rays, forward)."""
    return run.spec.counts.model_ops(run.spec.flags, run.rays_per_unit, run.train)


def mfu(run) -> Optional[float]:
    """The model's operations over the untraced window, as a share (%) of
    the f32 peak."""
    w = run.window
    if not w.units or not w.elapsed_s:
        return None
    return 100.0 * model_ops_per_unit(run) * w.units / w.elapsed_s / work.F32_OPS_PER_S


def group_s(run, *groups: str) -> Optional[float]:
    """Device seconds of the traced groups, None without a trace or where
    they ran nothing."""
    if run.trace is None:
        return None
    s = sum(run.trace["groups"].get(g, 0.0) for g in groups)
    return s if s > 0 else None


def idle_share(run) -> Optional[float]:
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_roofline(run, kernel: str) -> Optional[float]:
    """The share (%) of the roofline that a kernel family (render_core or
    flow_stack) reaches over the traced window: its launches' least time
    (the family's counts) over the device time of its kernels.  None where
    the family did not run, or ran another number of launches than the
    path's shapes account for."""
    names = (f"{kernel}_fwd", f"{kernel}_bwd")[:2 if run.train else 1]
    seconds = group_s(run, *names)
    if seconds is None:
        return None
    counts, flags = run.spec.counts, run.spec.flags
    renders = run.traced.units * (1 if run.train else run.tiles_per_view)
    per_render = counts.launches_per_render(flags, kernel)
    if any(run.traced.launches.get(n, 0) != renders * per_render for n in names):
        return None
    # a launch covers a training step's rays, or a whole serving tile
    n_rays = run.rays_per_unit if run.train else int(flags["chunk"])
    bound_ms = sum(counts.kernel_bound_ms(flags, kernel, n_rays, run.train, backward)
                   for backward in (False, True)[:len(names)])
    return 100.0 * bound_ms * 1e-3 * renders / seconds


def trunk_gemm_roofline(run) -> Optional[float]:
    """The share (%) of the roofline that the GEMM kernels reach: the
    operations and bytes of every nn.Linear (trunk, heads, amortizers) of
    the traced window's work, at the f32 peak, over the device time of the
    "matmul" group."""
    seconds = group_s(run, "matmul")
    if seconds is None:
        return None
    counts, flags, units = run.spec.counts, run.spec.flags, run.traced.units
    ops = counts.linear_ops(flags, run.rays_per_unit, run.train) * units
    nbytes = counts.linear_bytes(flags, run.rays_per_unit, run.train) * units
    return 100.0 * work.bound_ms(nbytes, ops)[0] * 1e-3 / seconds


def eager_ms_per_unit(run) -> Optional[float]:
    """Device ms of the "other" group (kernels that are neither GEMMs, nor
    the port's, nor copies) a training step, or a serving tile."""
    seconds = group_s(run, "other")
    if seconds is None or not run.traced.units:
        return None
    return 1e3 * seconds / (run.traced.units * (1 if run.train else run.tiles_per_view))
