"""device_idle.*: 1 - (the union of kernel, memcpy and memset intervals) over
the traced window (torch.profiler), in %."""
from benchmark import readers


def read(run):
    return readers.idle_share(run)
