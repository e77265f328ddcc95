"""train_step_ms_p95: the 95th percentile (linear between order
statistics) of every training step's time in the window, each from the
request of its batch from the prefetcher to the synchronize after the
step."""
import numpy as np


def read(run):
    w = run.window
    if not run.train or not w.units:
        return None
    return float(np.percentile(np.asarray(w.durations) * 1e3, 95))
