"""train_rays_per_s.*: the rays of every training step completed in the
window over the window's length (host clock, each step ending in a
synchronize)."""


def read(run):
    w = run.window
    return run.rays_per_unit * w.units / w.elapsed_s if run.train and w.units else None
