"""Several runs and several devices; counterpart of cfnerf_tpu/parallel.
ensemble.py trains an ensemble's members in one call and lays them over an
(ensemble, data) mesh; mesh.py is the (data, model) mesh over
torch.distributed."""
