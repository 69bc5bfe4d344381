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
Training writes TensorBoard scalars under ``args.tfboard_path`` (``train/``
and ``test/``) through ``tensorboardX`` where it imports, else
``torch.utils.tensorboard`` where ``tensorboard`` imports, else none, as
``main.py:86-99`` of the JAX package does.

On several GPUs, one process a card::

    torchrun --nproc_per_node 8 -m imgadapointr_tpu_torch.main --launcher pytorch \\
        --config cfgs/PCN_models/AdaPoinTr.yaml --exp_name run0 [--tp 2] [--sp 2]

:func:`init_distributed` joins the processes (NCCL on ``cuda:LOCAL_RANK``,
gloo under ``--device cpu``); each seeds its host generators with ``seed +
rank`` (JAX ``main.py:68``), and rank 0 alone logs and writes the
TensorBoard scalars (JAX ``main.py:89``).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch
import torch.distributed as tdist

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


def make_writers(args) -> tuple:
    """(train, test) TensorBoard writers under ``args.tfboard_path``, or
    (None, None) when neither ``tensorboardX`` nor ``tensorboard`` imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            import tensorboard  # noqa: F401  (torch.utils.tensorboard needs it)
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None, None
    return (SummaryWriter(os.path.join(args.tfboard_path, "train")),
            SummaryWriter(os.path.join(args.tfboard_path, "test")))


def init_distributed(args) -> int:
    """Join the ranks of a ``torchrun`` / ``--launcher pytorch`` launch:
    ``torch.distributed`` from the environment, NCCL on
    ``cuda:LOCAL_RANK`` (``args.device`` becomes that card), gloo under
    ``--device cpu``. Returns this process's rank (0 without a launch)."""
    if not getattr(args, "distributed", False):
        return 0
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if torch.device(args.device).type == "cpu":
        backend = "gloo"
    else:
        local_rank = int(os.environ.get("LOCAL_RANK", args.local_rank))
        torch.cuda.set_device(local_rank)
        args.device = f"cuda:{local_rank}"
        backend = "nccl"
    tdist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return rank


def main(argv=None):
    args = get_args(argv)
    rank = init_distributed(args)
    try:
        return _main(args, rank)
    finally:
        if tdist.is_available() and tdist.is_initialized():
            tdist.destroy_process_group()


def _main(args, rank: int):
    timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
    log_file = os.path.join(args.experiment_path, f"{timestamp}.log")
    # rank 0 alone logs (its console and its file); the others keep quiet
    args.logger = logger = get_logger(args.log_name, log_file) if rank == 0 else "silent"

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

    seed = args.seed + rank  # the host generators differ by rank, as JAX main.py:68 seeds them
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print_log(f"config: {config}", logger)

    if args.test:
        return test_net(args, config)
    writers = make_writers(args) if rank == 0 else (None, None)
    if writers[0] is None and rank == 0:
        print_log("TensorBoard writers off: neither tensorboardX nor tensorboard imports", logger)
    try:
        return run_net(args, config, writers)
    finally:
        for w in writers:
            if w is not None:
                w.close()


if __name__ == "__main__":
    main()
