"""eager_device_ms.*: traced device ms a training step, or a serving tile,
of the kernels that are neither GEMMs, nor the port's kernels, nor
copies."""
from benchmark import readers


def read(run):
    return readers.eager_ms_per_unit(run)
