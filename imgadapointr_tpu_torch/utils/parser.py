"""Command-line flags of the train / test entry point.

The flags of ``imgadapointr_tpu/utils/parser.py``, plus ``--device``
(default ``cuda``; the CPU runs only when asked for). ``experiments/`` goes
under the current directory; ``args.tfboard_path`` is
``experiments/<stem>/<parent>/TFBoard/<exp_name>`` (the TensorBoard
writers' and ``--profile``'s directory).

Several processes: ``--launcher pytorch``, or a ``WORLD_SIZE`` above 1 in
the environment (``torchrun``), makes ``main`` initialise
``torch.distributed`` from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``, else ``--local_rank`` as
the reference's ``torch.distributed.launch`` passed it). ``--tp`` and
``--sp`` (tensor and point-axis widths) must divide the world; the data
width is what is left.

Inert compat flags, accepted with a notice so that a reference command
line runs unchanged: ``--sync_bn`` (with several ranks the batch statistics
are always the global batch's, as under JAX's GSPMD) and
``--deterministic`` (a train step is deterministic already: no kernel adds
with float atomics and ``Runner.train_step`` holds cuDNN to its
deterministic algorithms).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

COMPAT_NOTICE = ("[parser] {flag} accepted for reference-CLI compatibility; "
                 "it has no effect here (see utils/parser.py docstring)")
SYNC_BN_NOTICE = ("[parser] --sync_bn accepted for reference-CLI compatibility: with several ranks "
                  "BatchNorm always takes the global batch's statistics")


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="yaml config file")
    parser.add_argument("--exp_name", type=str, default="default", help="experiment name")
    parser.add_argument("--seed", type=int, default=0, help="random seed")
    parser.add_argument("--num_workers", type=int, default=8, help="loader workers")
    parser.add_argument("--worker_mode", choices=["thread", "process"], default="thread",
                        help="loader workers: threads of this process (default) or worker processes")
    parser.add_argument("--val_freq", type=int, default=1, help="validate every N epochs")
    parser.add_argument("--save_freq", type=int, default=1,
                        help="ckpt-best and ckpt-last every N epochs (and on the last two)")
    parser.add_argument("--val_bs", type=int, default=1,
                        help="validation and test batch size (1 = the reference protocol; KITTI's test stays 1)")
    parser.add_argument("--mode", choices=["easy", "median", "hard"], default=None,
                        help="ShapeNet-55 test: the share of each cloud cropped (default median)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from ckpt-last.pth, or from a JAX run's ckpt-last.ckpt")
    parser.add_argument("--start_ckpts", type=str, default=None,
                        help="warm-start the weights from a .pth or a JAX .ckpt; fresh optimizer")
    parser.add_argument("--ckpts", type=str, default=None, help="weights for --test (.pth or JAX .ckpt)")
    parser.add_argument("--test", action="store_true", help="run the test protocol")
    parser.add_argument("--synthetic", action="store_true", help="use SyntheticPCN data")
    parser.add_argument("--syn_train_len", type=int, default=None,
                        help="--synthetic train-split length (default $SYN_TRAIN_LEN or 64)")
    parser.add_argument("--no_emd", dest="emd", action="store_false", default=True,
                        help="skip the auction EMD in --test (on by default; EMDistance then reads 0)")
    parser.add_argument("--gdanet_w", type=str, default=None,
                        help="reference GDANet checkpoint for the segmentation models' frozen GDANet")
    parser.add_argument("--wandb", action="store_true", help="log to wandb, where it is installed")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of train steps 1-5 into the TFBoard directory")
    parser.add_argument("--tp", type=int, default=1, help="tensor-parallel width (divides the world)")
    parser.add_argument("--sp", type=int, default=1, help="point-axis-parallel width (divides the world)")
    parser.add_argument("--deterministic", action="store_true", help="no-op: a train step is deterministic")
    parser.add_argument("--sync_bn", action="store_true",
                        help="no-op: with several ranks BatchNorm takes the global batch's statistics")
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="pytorch: one process a device, torch.distributed from the environment")
    parser.add_argument("--local_rank", "--local-rank", type=int, default=0,
                        help="this process's device (LOCAL_RANK of the environment wins)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.deterministic:
        print(COMPAT_NOTICE.format(flag="--deterministic"))
    if args.sync_bn:
        print(SYNC_BN_NOTICE)
    for flag, width in (("--tp", args.tp), ("--sp", args.sp)):
        if width < 1:
            parser.error(f"{flag} {width}: a width is at least 1")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    args.distributed = args.launcher == "pytorch" or world > 1
    if not args.distributed and args.tp * args.sp > 1:
        parser.error(f"--tp {args.tp} --sp {args.sp}: launch one process a device "
                     "(torchrun ... --launcher pytorch) for widths above 1")
    if world % (args.tp * args.sp):
        parser.error(f"--tp {args.tp} x --sp {args.sp} does not divide the world of {world} ranks")

    if args.test and args.resume:
        parser.error("--test and --resume cannot be both activated")
    if args.resume and args.start_ckpts is not None:
        parser.error("--resume and --start_ckpts cannot be both activated")
    if args.test and args.ckpts is None:
        print("[WARN] testing without --ckpts (random init)")

    stem = Path(args.config).stem
    parent = Path(args.config).parent.name
    args.experiment_path = os.path.join("experiments", stem, parent, args.exp_name)
    args.tfboard_path = os.path.join("experiments", stem, parent, "TFBoard", args.exp_name)
    args.log_name = stem
    os.makedirs(args.experiment_path, exist_ok=True)
    os.makedirs(args.tfboard_path, exist_ok=True)
    return args
