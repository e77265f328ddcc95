"""graph_step_share.*: 100 x the program's counter train.graph_replay (steps
run as a replay of the step's CUDA graph) over the traced window's steps, in
%.  None where the program counted neither a replay nor an eager call of a
graphed step (train.graph_eager): a program without the graph."""
from benchmark import program_trace


def read(run):
    replays = program_trace.counter(run, "train.graph_replay")
    if not replays and not program_trace.counter(run, "train.graph_eager"):
        return None
    return 100.0 * replays / run.traced.units
