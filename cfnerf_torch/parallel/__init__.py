"""Several runs at once; counterpart of cfnerf_tpu/parallel.  ensemble.py
trains an ensemble's members in one call on one device.  Several devices
(cfnerf_tpu/parallel/mesh.py) come with slice 8c."""
