"""trunk_gemm_roofline.*: every nn.Linear's operations and bytes (trunk,
heads, amortizers; forward, and backward in training) at the f32 peak,
over the traced device time of the GEMM kernels."""
from benchmark import readers


def read(run):
    return readers.trunk_gemm_roofline(run)
