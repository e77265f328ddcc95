"""forward_host_ms.*: the mean host ms of the program's span
cfnerf.train.forward (the loss: rays, placement, render, loss) over the
traced window's steps."""
from benchmark import program_trace


def read(run):
    return program_trace.mean_ms(run, "cfnerf.train.forward")
