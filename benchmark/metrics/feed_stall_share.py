"""feed_stall_share.*: the share (%) of the traced window's calls of the
prefetcher's next() (the program's span cfnerf.feed.next) that found no
batch ready (its counter feed.empty)."""
from benchmark import program_trace


def read(run):
    n = program_trace.calls(run, "cfnerf.feed.next")
    empty = program_trace.counter(run, "feed.empty")
    return None if n is None or empty is None else 100.0 * empty / n
