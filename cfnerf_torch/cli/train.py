"""Training / rendering entry point; counterpart of cfnerf_tpu/cli/train.py.

    python -m cfnerf_torch.cli.train --config configs/africa_ds.txt \
        --expname africa --N_rand 512 --N_samples 128 --n_flows 4 \
        --h_alpha_size 64 --h_rgb_size 64 --K_samples 32 \
        --type_flows triangular --beta1 0.01 --depth_lambda 0.01 \
        --netdepth 8 --netwidth 512 --is_train

(scripts/train_NF.sh's flags.)  Without --is_train the run renders instead
(--render_only), as the JAX entry point does.  Runs on the CUDA device;
main(argv, device="cpu") runs the same path on the CPU.
"""
from __future__ import annotations

from cfnerf_torch.train.loop import train
from cfnerf_torch.utils.config import parse_args
from cfnerf_torch.utils.device import DeviceLike


def main(argv=None, device: DeviceLike = None):
    args = parse_args(argv)
    if not args.is_train and not args.render_only:
        print("--is_train not set: running evaluation (--render_only).")
        args.render_only = True
    train(args, device=device)


if __name__ == "__main__":
    main()
