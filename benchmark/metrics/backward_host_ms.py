"""backward_host_ms.*: the mean host ms of the program's span
cfnerf.train.backward (loss.backward(), which the main thread waits in
while autograd's engine runs the backward) over the traced window's
steps."""
from benchmark import program_trace


def read(run):
    return program_trace.mean_ms(run, "cfnerf.train.backward")
