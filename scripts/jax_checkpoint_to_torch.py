#!/usr/bin/env python3
"""Convert a cfnerf_tpu (JAX, Orbax) checkpoint into a cfnerf_torch one.

    python scripts/jax_checkpoint_to_torch.py --jax_ckpt CKPT_DIR [--out RUN_DIR] FLAGS...

FLAGS are the flags of the JAX run (e.g. --config configs/africa_ds.txt
--netdepth 8 --netwidth 512 ... as scripts/train_NF.sh passes them): the
JAX model is built from them, the checkpoint read as cfnerf_tpu's
restore_checkpoint reads it (filtered into that model's fresh params), each
network's test-mode eps taken from the JAX model (NeRFFlows' `_test_eps`;
nerf_wild's normal draws from PRNGKey(test_eps_seed); the other baselines
have none), and the weights mapped through cfnerf_torch.convert's
state_dict_from_jax, which picks the map from --model and --type_flows,
into the port's state dicts.
They are written with the port's save_checkpoint under the checkpoint's own
{step:06d}_{ensemble:02d} name, into RUN_DIR, by default the run dir the
flags name (basedir/dataname/type_flows/expname), where the port's
create_nerf resumes from it with the same flags.  The optimizer state is not
carried over: neither package restores it.

Orbax imports jax, so this script lives outside cfnerf_torch/, which must
not; it imports both packages.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def convert(jax_ckpt: str, args, out: Optional[str] = None) -> str:
    """Convert the checkpoint directory `jax_ckpt` of a JAX run with flags
    `args` (cfnerf_tpu's parse_args); returns the port checkpoint's path."""
    import jax
    import numpy as np

    from cfnerf_tpu.models import factory as jfactory
    from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
    from cfnerf_tpu.train import checkpoint as jckpt
    from cfnerf_torch.convert import state_dict_from_jax
    from cfnerf_torch.train import checkpoint as tckpt

    model, model_fine, _ = jfactory.build_model(args)
    seed = getattr(args, "seed", 0)
    fresh = jfactory.init_params(model, seed)
    if model_fine is not None:
        fresh = {"coarse": fresh, "fine": jfactory.init_params(model_fine, seed + 1)}
    params, step = jckpt.restore_checkpoint(jax_ckpt, fresh)
    params = jax.tree_util.tree_map(np.asarray, params)

    nets = [("coarse", model, params if model_fine is None else params["coarse"])]
    if model_fine is not None:
        nets.append(("fine", model_fine, params["fine"]))
    state = {}
    for name, net, p in nets:
        if isinstance(net, JaxNeRFFlows):
            eps = tuple(np.asarray(e) for e in
                        net.apply({"params": p}, method=JaxNeRFFlows._test_eps))
        elif net.kind == "nerf_wild":
            eps = np.asarray(jax.random.normal(jax.random.PRNGKey(net.test_eps_seed),
                                               (net.k_samples, 3)))
        else:
            eps = None
        state[name] = state_dict_from_jax(p, args.model, args.type_flows, eps)

    m = tckpt._CKPT_RE.match(os.path.basename(os.path.normpath(jax_ckpt)))
    ensemble = int(m.group(2)) if m else args.index_ensembles
    rundir = out or tckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    target = tckpt.checkpoint_path(rundir, step, ensemble)
    if os.path.abspath(target) == os.path.abspath(jax_ckpt):
        raise ValueError(f"{target} is the JAX checkpoint itself: pass --out (or "
                         "another --basedir or --expname) for the port's copy")
    return tckpt.save_checkpoint(rundir, step, state, None, ensemble)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from cfnerf_tpu.utils.config import parse_args

    pre = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    pre.add_argument("--jax_ckpt", required=True,
                     help="the JAX checkpoint directory, e.g. RUN_DIR/010000_01")
    pre.add_argument("--out", default=None,
                     help="run dir for the port's checkpoint (default: the flags' run dir)")
    known, rest = pre.parse_known_args(argv)
    path = convert(known.jax_ckpt, parse_args(rest), known.out)
    print("Wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
