"""The port's flag parser against cfnerf_tpu's: the same flags (name, dest,
default, type, choices, action), the same namespaces from every config in
configs/ with and without CLI overrides, the same ignored-flag warnings, and
an args.txt snapshot that parses back to the namespace it was written from."""
import argparse
from pathlib import Path

import pytest

from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.utils import config as jconfig
from cfnerf_torch.train import loop as tloop
from cfnerf_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.txt"))

# scripts/train_NF.sh's flags
TRAIN_NF = ["--config", str(ROOT / "configs" / "africa_ds.txt"), "--expname", "africa",
            "--N_rand", "512", "--N_samples", "128", "--n_flows", "4", "--h_alpha_size", "64",
            "--h_rgb_size", "64", "--K_samples", "32", "--n_hidden", "128",
            "--type_flows", "triangular", "--beta1", "0.01", "--depth_lambda", "0.01",
            "--netdepth", "8", "--netwidth", "512", "--model", "NeRF_Flows",
            "--index_step", "-1", "--is_train"]
OVERRIDES = {
    "none": [],
    "cli": ["--factor", "4", "--dataname", "statue", "--no_ndc", "--lrate", "1e-3",
            "--type_flows", "planar", "--model", "nerf", "--ft_path", "None"],
    "train_NF": TRAIN_NF[2:],
}


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _describe(a):
    return dict(option_strings=a.option_strings, default=a.default, type=a.type,
                choices=a.choices, nargs=a.nargs, const=a.const, kind=type(a).__name__,
                required=a.required)


JAX_ACTIONS = _actions(jconfig.config_parser())


def test_both_parsers_have_the_same_flags():
    assert set(_actions(tconfig.config_parser())) == set(JAX_ACTIONS)


@pytest.mark.parametrize("dest", sorted(JAX_ACTIONS))
def test_flag_matches_jax(dest):
    port = _actions(tconfig.config_parser())[dest]
    assert _describe(port) == _describe(JAX_ACTIONS[dest])


def test_jax_defaults_the_factory_refuses_are_kept():
    args = tconfig.parse_args([])
    assert args.type_flows == "no_flow" and args.model is None
    assert args.netwidth == 256 and args.K_samples == 64


@pytest.mark.parametrize("override", list(OVERRIDES))
@pytest.mark.parametrize("config", CONFIGS)
def test_configs_parse_to_the_same_namespace(config, override):
    argv = ["--config", str(ROOT / "configs" / config)] + OVERRIDES[override]
    assert vars(tconfig.parse_args(argv)) == vars(jconfig.parse_args(argv))


def test_train_nf_sh_flags():
    args = tconfig.parse_args(TRAIN_NF)
    assert vars(args) == vars(jconfig.parse_args(TRAIN_NF))
    assert (args.netdepth, args.netwidth, args.N_samples, args.K_samples, args.n_flows,
            args.h_alpha_size, args.h_rgb_size) == (8, 512, 128, 32, 4, 64, 64)
    assert args.no_ndc and args.colmap_depth and args.factor == 2


@pytest.mark.parametrize("argv", [[], ["--lrate_unc", "1e-3", "--n_hidden", "64",
                                       "--netchunk_per_gpu", "1024"]])
def test_ignored_flags_warn_as_jax(argv, capsys):
    assert tconfig.IGNORED_FLAGS.keys() == jconfig.IGNORED_FLAGS.keys()
    assert tconfig._IGNORED_DEFAULTS == jconfig._IGNORED_DEFAULTS
    assert (tconfig.warn_ignored_flags(tconfig.parse_args(argv))
            == jconfig.warn_ignored_flags(jconfig.parse_args(argv)))


@pytest.mark.parametrize("config", ["africa_ds.txt", "minicapture_ds.txt"])
def test_args_txt_round_trips(config, tmp_path):
    """_snapshot_args writes args.txt and config.txt; args.txt parses back
    to the same namespace (unset flags as None, not "None") in both
    packages, and the port's file is the JAX package's, line for line."""
    argv = TRAIN_NF[2:] + ["--config", str(ROOT / "configs" / config)]
    args = tconfig.parse_args(argv)
    assert args.ft_path is None and args.profile_dir is None
    tloop._snapshot_args(args, str(tmp_path / "port"))
    jloop._snapshot_args(jconfig.parse_args(argv), str(tmp_path / "jax"))
    for name in ("args.txt", "config.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "config.txt").read_text() == \
        (ROOT / "configs" / config).read_text()
    snap = str(tmp_path / "port" / "args.txt")
    for parse in (tconfig.parse_args, jconfig.parse_args):
        back = vars(parse(["--config", snap]))
        want = dict(vars(args), config=snap)
        assert back == want
