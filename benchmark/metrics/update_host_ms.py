"""update_host_ms.*: the host ms a step of the program's spans
cfnerf.train.zero_grad and cfnerf.train.update (a mesh's all-reduce, Adam,
the schedule) over the traced window."""
from benchmark import program_trace


def read(run):
    ms = program_trace.total_ms(run, "cfnerf.train.zero_grad", "cfnerf.train.update")
    return None if ms is None else ms / program_trace.calls(run, "cfnerf.train.update")
