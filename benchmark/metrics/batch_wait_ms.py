"""batch_wait_ms.*: the mean host ms a training step of the untraced window
waits in the port's BatchPrefetcher.next, from the benchmark's own clock
around the call."""


def read(run):
    waits = run.window.waits
    return 1e3 * sum(waits) / len(waits) if run.train and waits else None
