"""Entry point: train or test a model from a YAML config.

    python -m imgadapointr_tpu_torch.main --config cfgs/PCN_models/AdaPoinTr.yaml \\
        --exp_name run0 --synthetic                    # train, validate, checkpoint
    python -m imgadapointr_tpu_torch.main --config ... --exp_name run0 --synthetic --resume
    python -m imgadapointr_tpu_torch.main --config ... --synthetic --test \\
        --ckpts experiments/AdaPoinTr/PCN_models/run0/ckpt-best.pth

Counterpart of the JAX package's ``main.py``. Runs on the GPU unless
``--device cpu`` is given. ``--synthetic`` swaps every dataset split for
``SyntheticPCN``; it is the only data source so far (the PCN and ShapeNet
readers wait for dataset files).
"""

from __future__ import annotations

import os
import time

import torch

from .tools.runner import run_net, test_net
from .utils.config import get_config
from .utils.logger import get_logger, print_log
from .utils.parser import get_args


def swap_synthetic(config, train_len: int | None = None) -> None:
    """Point every dataset split at SyntheticPCN, keeping the model's
    shapes, with images for an image model and class one-hots for a
    segmentation model (by name, as ``main.py:114-115`` of the JAX package
    decides). ``train_len`` falls back to $SYN_TRAIN_LEN, then 64."""
    if train_len is None:
        train_len = int(os.environ.get("SYN_TRAIN_LEN", 64))
    n_points = int(config.model.get("num_points", 16384))
    for split in ("train", "val", "test"):
        if split in config.dataset:
            sub = config.dataset[split]
            names = (sub.get("NAME", ""), config.model.NAME)
            config.dataset[split] = {
                "NAME": "SyntheticPCN", "N_POINTS": n_points,
                "LENGTH": int(train_len) if split == "train" else 16,
                "WITH_IMG": any("Img" in n for n in names),
                "WITH_CLS": any("Seg" in n for n in names),
                "others": dict(sub.get("others", {})),
            }


def main(argv=None):
    args = get_args(argv)
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    log_file = os.path.join(args.experiment_path, f"{timestamp}.log")
    args.logger = logger = get_logger(args.log_name, log_file)

    config = get_config(args)
    if args.synthetic:
        swap_synthetic(config, train_len=args.syn_train_len)
    config.dataset.train.others.bs = config.total_bs
    for split in ("val", "test"):  # the reference protocol evaluates at batch size 1
        if split in config.dataset:
            config.dataset[split].others.bs = 1

    torch.manual_seed(args.seed)
    print_log(f"config: {config}", logger)

    if args.test:
        return test_net(args, config)
    return run_net(args, config)


if __name__ == "__main__":
    main()
