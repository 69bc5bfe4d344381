"""Entry point: train or test a model from a YAML config.

    python -m imgadapointr_tpu_torch.main --config cfgs/PCN_models/AdaPoinTr.yaml \\
        --exp_name run0                                # train, validate, checkpoint
    python -m imgadapointr_tpu_torch.main --config ... --exp_name run0 --resume
    python -m imgadapointr_tpu_torch.main --config ... --test \\
        --ckpts experiments/AdaPoinTr/PCN_models/run0/ckpt-best.pth [--val_bs 8]
    python -m imgadapointr_tpu_torch.main --config cfgs/ShapeNet55_models/AdaPoinTr.yaml \\
        --test --ckpts ... --mode hard                 # the 8-viewpoint crop protocol

Counterpart of the JAX package's ``main.py``. Runs on the GPU unless
``--device cpu`` is given. The configs' dataset blocks name the readers
and their trees (``cfgs/dataset_configs/``, paths relative to the working
directory); ``--synthetic`` swaps every split for ``SyntheticPCN``.
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
    shapes (a ground truth of ``num_points``, else ``num_pred``, else 16384
    points), with images for an image model and class one-hots for a
    segmentation model (by name, as ``main.py:114-115`` of the JAX package
    decides). ``train_len`` falls back to $SYN_TRAIN_LEN, then 64."""
    if train_len is None:
        train_len = int(os.environ.get("SYN_TRAIN_LEN", 64))
    n_points = int(config.model.get("num_points", config.model.get("num_pred", 16384)))
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
    # the reference protocol evaluates at batch size 1; --val_bs batches
    # validation and the PCN and ShapeNet-55 tests with per-sample rows.
    # KITTI's test draws one image a cloud and stays at 1
    for split in ("val", "test"):
        if split in config.dataset:
            kitti = split == "test" and config.dataset.test.get("NAME", "") == "KITTI"
            config.dataset[split].others.bs = 1 if kitti else max(1, args.val_bs)

    torch.manual_seed(args.seed)
    print_log(f"config: {config}", logger)

    if args.test:
        return test_net(args, config)
    return run_net(args, config)


if __name__ == "__main__":
    main()
