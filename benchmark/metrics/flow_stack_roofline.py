"""flow_stack_roofline.*: the flow stack's launches' least time (forward,
and backward in training; two chains a pass; the yardstick's operations
and bytes at the H100's peaks) over their device time in the traced
window."""
from benchmark import readers


def read(run):
    return readers.kernel_roofline(run, "flow_stack")
