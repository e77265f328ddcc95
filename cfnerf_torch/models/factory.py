"""Model factory — counterpart of cfnerf_tpu/models/factory.py (reference
create_nerf, run_nerf_uncertainty_NF.py:317-341).

Reads the same flag names as cfnerf_tpu/utils/config.py.  It builds
NeRFFlows of any --type_flows the JAX package implements (realnvp and glow
raise its ValueError), or with --model nerf / nerf_dropout / nerf_wild the
baselines under KSampleBaseline, in f32 or bf16 (--compute_dtype), and with
--N_importance > 0 the fine network; an unknown --model raises ValueError.
create_nerf builds and resumes from the run dir's checkpoints, as
cfnerf_tpu/models/factory.py:create_nerf does.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from cfnerf_torch.models.baseline_adapter import BASELINE_KINDS, KSampleBaseline
from cfnerf_torch.models.nerf_flows import COMPUTE_DTYPES, FLOW_IMPLS, TRUNK_IMPLS, NeRFFlows
from cfnerf_torch.ops.embed import get_embedder
from cfnerf_torch.render.renderer import FUSED_MODES, RenderConfig
from cfnerf_torch.train import checkpoint as ckpt
from cfnerf_torch.utils.device import DeviceLike, resolve_device


Model = Union[NeRFFlows, KSampleBaseline]


def model_name_of(args) -> str:
    """--model, lower-cased; 'NeRF_Flows' (the reference scripts' spelling)
    and no value are the flow model, 'nerf_flows'."""
    return (getattr(args, "model", None) or "nerf_flows").lower()


def loss_mode_for_model(model_name: Optional[str]) -> str:
    """The training loss of a model (cfnerf_tpu/models/factory.py:
    loss_mode_for_model): the KDE NLL for the flow model and nerf_wild, MSE
    for nerf and nerf_dropout (K identical or mask-only draws make a KDE
    bandwidth degenerate)."""
    name = (model_name or "nerf_flows").lower()
    return "mse" if name in ("nerf", "nerf_dropout") else "kde"


def resolve_fused_render(args) -> str:
    """--fused_render as RenderConfig.fused: 'auto' is 'on' (the render core)
    for the triangular NeRFFlows only, else 'off', as JAX's factory resolves
    it; an explicit 'on' or 'interpret' for any other model raises JAX's
    ValueError (cfnerf_tpu/models/nerf_flows.py:make_fused_apply)."""
    mode = getattr(args, "fused_render", "auto")
    name = model_name_of(args)
    triangular = name == "nerf_flows" and args.type_flows == "triangular"
    if mode == "auto":
        return "on" if triangular else "off"
    if mode in ("on", "interpret") and not triangular:
        kind = "NeRFFlows" if name == "nerf_flows" else "KSampleBaseline"
        type_flows = args.type_flows if name == "nerf_flows" else None
        raise ValueError(
            f"--fused_render={mode} requires the triangular NeRFFlows "
            f"model (got {kind} with type_flows={type_flows!r}); use "
            "--fused_render=off or auto"
        )
    return mode


def _check_supported(args) -> None:
    model_name = model_name_of(args)
    if model_name != "nerf_flows" and model_name not in BASELINE_KINDS:
        raise ValueError(
            f"unknown baseline model {model_name!r}; choose from "
            f"{BASELINE_KINDS} or the default flow model"
        )
    compute_dtype = getattr(args, "compute_dtype", "float32")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"--compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    trunk_impl = getattr(args, "trunk_impl", "xla")
    if trunk_impl not in TRUNK_IMPLS:
        raise ValueError(f"--trunk_impl must be one of {TRUNK_IMPLS}, got {trunk_impl!r}")
    flow_impl = getattr(args, "flow_impl", "auto")
    if flow_impl not in FLOW_IMPLS:
        raise ValueError(f"--flow_impl must be one of {FLOW_IMPLS}, got {flow_impl!r}")
    fused = getattr(args, "fused_render", "auto")
    if fused not in ("auto",) + FUSED_MODES:
        raise ValueError(f"--fused_render must be one of {('auto',) + FUSED_MODES}, "
                         f"got {fused!r}")


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every nn.Linear (IAF's masked ones too) from torch.nn.Linear's
    default distribution, U(+-1/sqrt(fan_in)) for weight and bias (the JAX
    package's TorchDense and MaskedDense match it), from an explicit
    torch.Generator; base parameters go to mean 0, std 1.  In place;
    returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                w = torch.empty(m.weight.shape).uniform_(-bound, bound, generator=g)
                b = torch.empty(m.bias.shape).uniform_(-bound, bound, generator=g)
                m.weight.copy_(w)
                m.bias.copy_(b)
        if isinstance(model, NeRFFlows):
            model.alpha_mean.zero_()
            model.rgb_mean.zero_()
            model.alpha_std.fill_(1.0)
            model.rgb_std.fill_(1.0)
    return model


def build_model(
    args, device: DeviceLike = None
) -> Tuple[Model, Optional[Model], RenderConfig]:
    """Build the model + render config from the flag namespace.

    Returns (model, model_fine, render_config).  With --N_importance > 0,
    model_fine is the hierarchical fine network at --netdepth_fine /
    --netwidth_fine (cfnerf_tpu/models/factory.py:93-97), else None.
    --trunk_impl (xla, pallas or interpret; default xla), --flow_impl
    (auto, xla, pallas or interpret; default auto, the flow-stack kernel) and
    --compute_dtype (float32 or bfloat16; default float32, the xla trunk's
    arithmetic, parameters f32 either way) go to both nets, as
    cfnerf_tpu/models/factory.py:33,73,87-89 passes them.
    --fused_render (auto, on, off or interpret; default auto) becomes
    RenderConfig.fused through resolve_fused_render: auto is 'on' (the render
    core, the kernel on the card, as JAX's factory resolves it to its kernel
    on a TPU) for the triangular NeRFFlows and 'off' (the unfused path)
    for every other model.  An unknown value of any of them raises.
    --model nerf / nerf_dropout / nerf_wild builds KSampleBaseline nets
    (cfnerf_tpu/models/factory.py:58-72), which --trunk_impl and
    --flow_impl do not reach; --type_flows picks NeRFFlows' family.
    Weights come from init_params(seed=args.seed), the fine network's from
    seed + 1, as create_nerf seeds them.  The models live on the CUDA device
    unless device="cpu" is passed; with no CUDA device and no explicit
    device this raises."""
    dev = resolve_device(device)
    _check_supported(args)
    _, input_ch = get_embedder(args.multires, args.i_embed)
    input_ch_views = 0
    if args.use_viewdirs:
        _, input_ch_views = get_embedder(args.multires_views, args.i_embed)
    seed = getattr(args, "seed", 0)
    fused_render = resolve_fused_render(args)
    model_name = model_name_of(args)
    compute_dtype = COMPUTE_DTYPES[getattr(args, "compute_dtype", "float32")]

    def make(depth: int, width: int, seed: int) -> Model:
        if model_name != "nerf_flows":
            return init_params(KSampleBaseline(
                kind=model_name, k_samples=args.K_samples, net_depth=depth,
                net_width=width, input_ch=input_ch, input_ch_views=input_ch_views,
                skips=(depth // 2,), use_viewdirs=args.use_viewdirs,
                compute_dtype=compute_dtype), seed).to(dev)
        model = NeRFFlows(
            net_depth=depth,
            net_width=width,
            input_ch=input_ch,
            input_ch_views=input_ch_views,
            skips=(depth // 2,),  # reference: [netdepth/2] (:327)
            h_alpha_size=args.h_alpha_size,
            h_rgb_size=args.h_rgb_size,
            n_flows=args.n_flows,
            k_samples=args.K_samples,
            use_viewdirs=args.use_viewdirs,
            type_flows=args.type_flows,
            trunk_impl=getattr(args, "trunk_impl", "xla"),
            flow_impl=getattr(args, "flow_impl", "auto"),
            compute_dtype=compute_dtype,
        )
        return init_params(model, seed).to(dev)

    model = make(args.netdepth, args.netwidth, seed)
    model_fine = None
    if args.N_importance > 0:
        model_fine = make(args.netdepth_fine, args.netwidth_fine, seed + 1)
    render_config = RenderConfig(
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb > 0,
        lindisp=getattr(args, "lindisp", False),
        use_viewdirs=args.use_viewdirs,
        white_bkgd=args.white_bkgd,
        raw_noise_std=args.raw_noise_std,
        uniform=getattr(args, "uniformsample", False),
        multires=args.multires,
        multires_views=args.multires_views,
        i_embed=args.i_embed,
        fused=fused_render,
    )
    return model, model_fine, render_config


def create_nerf(
    args, device: DeviceLike = None
) -> Tuple[Model, Optional[Model], RenderConfig, int]:
    """Build + auto-resume (cfnerf_tpu/models/factory.py:130-158).

    Returns (model, model_fine, render_config, start): build_model's nets,
    then, unless --no_reload, the checkpoint that find_resume_checkpoint
    picks from the run dir basedir/dataname/type_flows/expname (or
    --ft_path; --index_step, --index_ensembles) filtered-merged into their
    state dicts, test-mode eps buffers included, and its global step as
    start (0 without one).  Pass start on as TrainConfig.start_step, so the
    lr schedule continues.  Prints "Reloading from <path>" or "No
    reloading", as JAX's create_nerf does."""
    model, model_fine, render_config = build_model(args, device)
    nets = {"coarse": model} if model_fine is None else {"coarse": model,
                                                          "fine": model_fine}
    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    start = 0
    path = None
    if not args.no_reload:
        path = ckpt.find_resume_checkpoint(
            rundir, ft_path=args.ft_path, index_step=args.index_step,
            ensemble=args.index_ensembles,
        )
    if path is not None:
        print("Reloading from", path)
        params, start = ckpt.restore_checkpoint(
            path, {name: net.state_dict() for name, net in nets.items()})
        for name, net in nets.items():
            net.load_state_dict(params[name])
    else:
        print("No reloading")
    return model, model_fine, render_config, start
