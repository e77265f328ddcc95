"""Command-line entry points of the port: `python -m cfnerf_torch.cli.train`
and `python -m cfnerf_torch.cli.eval`, with the JAX package's flags."""
