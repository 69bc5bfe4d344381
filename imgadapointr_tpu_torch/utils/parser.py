"""Command-line flags of the train / test entry point.

The flags of ``imgadapointr_tpu/utils/parser.py`` that the ported parts
honour, plus ``--device`` (default ``cuda``; the CPU runs only when asked
for). ``experiments/`` goes under the current directory.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--exp_name", type=str, default="default", help="experiment name")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
    parser.add_argument("--num_workers", type=int, default=8, help="loader worker processes")
    parser.add_argument("--val_freq", type=int, default=1, help="validate every N epochs")
    parser.add_argument("--save_freq", type=int, default=1,
                        help="ckpt-best and ckpt-last every N epochs (and on the last two)")
    parser.add_argument("--val_bs", type=int, default=1,
                        help="validation and test batch size (1 = the reference protocol; KITTI's test stays 1)")
    parser.add_argument("--mode", choices=["easy", "median", "hard"], default=None,
                        help="ShapeNet-55 test: the share of each cloud cropped (default median)")
    parser.add_argument("--resume", action="store_true", help="continue from ckpt-last.pth")
    parser.add_argument("--start_ckpts", type=str, default=None,
                        help="warm-start the weights from a .pth; fresh optimizer")
    parser.add_argument("--ckpts", type=str, default=None, help="weights for --test")
    parser.add_argument("--test", action="store_true", help="run the test protocol")
    parser.add_argument("--synthetic", action="store_true", help="use SyntheticPCN data")
    parser.add_argument("--syn_train_len", type=int, default=None,
                        help="--synthetic train-split length (default $SYN_TRAIN_LEN or 64)")
    parser.add_argument("--no_emd", dest="emd", action="store_false", default=True,
                        help="skip the auction EMD in --test (on by default; EMDistance then reads 0)")
    parser.add_argument("--gdanet_w", type=str, default=None,
                        help="reference GDANet checkpoint for the segmentation models' frozen GDANet")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.test and args.resume:
        parser.error("--test and --resume cannot be both activated")
    if args.resume and args.start_ckpts is not None:
        parser.error("--resume and --start_ckpts cannot be both activated")

    stem = Path(args.config).stem
    parent = Path(args.config).parent.name
    args.experiment_path = os.path.join("experiments", stem, parent, args.exp_name)
    args.log_name = stem
    os.makedirs(args.experiment_path, exist_ok=True)
    return args
