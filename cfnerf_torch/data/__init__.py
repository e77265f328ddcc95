from cfnerf_torch.data.llff import load_llff_data, load_colmap_depth
from cfnerf_torch.data.blender import load_blender_data
from cfnerf_torch.data.sampler import RayBatcher, DepthRayBatcher, precompute_rays, lf_scene_splits
