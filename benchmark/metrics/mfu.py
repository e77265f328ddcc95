"""mfu.*: the model's operations of every step (forward and backward of
every nn.Linear, the flows and the composite) or view (the same forward)
in the untraced window, from the family's counts (nothing recomputed), over
the window's length, as a share of the H100's f32 peak (67 TFLOP/s)."""
from benchmark import readers


def read(run):
    return readers.mfu(run)
