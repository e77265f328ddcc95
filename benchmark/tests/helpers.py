"""A cell of the benchmark cut to a size the CPU runs in seconds: the same
files and code, the widths, samples, draws and camera small.

Besides BENCHMARK.json's cells, `hier.train` (cfnerf-hier under the train
mix) keeps the hierarchical training path of the harness and the
reference under test, for the cell that PERF.md keeps for later."""
import copy
import json

from benchmark import harness

TINY = dict(netdepth=3, netwidth=32, netdepth_fine=3, netwidth_fine=32, N_samples=8,
            K_samples=4, h_alpha_size=16, h_rgb_size=16, N_rand=16, chunk=64, multires=4,
            multires_views=2)
# (configuration, mix) of cells kept for later, and the limits they are
# held to at the tiny size
LATER = {"hier.train": ("cfnerf-hier", "train",
                        {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-5})}


def _spec(workload: str) -> harness.Spec:
    if workload not in LATER:
        return harness.load_spec(workload)
    config, traffic, limits = LATER[workload]
    root = harness.REPO / "benchmark"
    read = lambda path: json.loads(path.read_text())  # noqa: E731
    return harness.Spec(name=workload, cell={"limits": limits, "chips": 1},
                        config=read(root / "configs" / f"{config}.json"),
                        traffic=read(root / "traffic" / f"{traffic}.json"),
                        end_to_end=[], per_layer=[])


def tiny_spec(workload: str) -> harness.Spec:
    spec = _spec(workload)
    spec.config = copy.deepcopy(spec.config)
    flags = spec.config["flags"]
    flags.update({k: v for k, v in TINY.items()
                  if k in flags or not k.endswith("_fine")})
    if flags.get("N_importance"):
        flags["N_importance"] = 8
    spec.traffic = copy.deepcopy(spec.traffic)
    spec.traffic["camera"].update(H=16, W=12)
    if spec.traffic["kind"] == "train":
        spec.traffic["scene"].update(n_views=3, depth_points_per_view=50)
    else:
        spec.traffic["compared_rays_per_view"] = 40
    return spec
