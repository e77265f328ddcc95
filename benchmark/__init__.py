"""The benchmark of cfnerf_torch: run one cell with `python benchmark/run.py`."""
