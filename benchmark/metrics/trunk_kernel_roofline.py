"""trunk_kernel_roofline.*: the trunk kernels' launches' least time (the
forward, and in training the backward; the family's counts of their
operations at the bf16 peak and bytes at the HBM bandwidth) over the
device time of the trunk_fwd and trunk_bwd groups in the traced window."""
from benchmark import readers


def read(run):
    return readers.kernel_roofline(run, "trunk")
