"""serve_rays_per_s.*: the pixels (rays) of every view completed in the
window over the window's length (host clock, each view ending in a
synchronize)."""


def read(run):
    w = run.window
    return run.rays_per_unit * w.units / w.elapsed_s if not run.train and w.units else None
