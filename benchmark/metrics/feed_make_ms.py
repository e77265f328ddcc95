"""feed_make_ms.*: the mean host ms of the program's span cfnerf.feed.make
(a batch sampled, put on the device and its draws made, on the
prefetcher's worker thread) over the traced window."""
from benchmark import program_trace


def read(run):
    return program_trace.mean_ms(run, "cfnerf.feed.make")
