"""Factories: data loaders, optimizer, schedules.

Counterpart of ``imgadapointr_tpu/tools/builder.py`` for the flagship's
recipe: ``torch.optim.AdamW`` with weight decay on the parameters of more
than one dimension only (biases and norm scales decay nothing, reference
``add_weight_decay``), the learning rate set before every step from the
epoch schedule at ``step / steps_per_epoch``. A frozen subtree (GDANet in
the segmentation models, whose parameters have ``requires_grad`` off) is in
neither group, as the reference's ``requires_grad=False`` keeps it out
(``imgadapointr_tpu/tools/builder.py:166-178``). Adam, SGD and gradient
accumulation (``step_per_update > 1``) wait for the models that use them.
"""

from __future__ import annotations

import torch
from torch.utils.data import DataLoader

from ..datasets import SyntheticPCN
from ..utils.schedulers import build_bnm_schedule, build_lr_schedule

# Parameter subtrees that get no gradient by construction: the query-ranking
# MLP (only the indices of its sorted scores are used) and the deformable
# offset nets. Their ``grad`` stays None after a backward, so AdamW skips
# them: no decay, no moments (imgadapointr_tpu/tools/builder.py:46-55).
ZERO_GRAD_PARAM_MARKERS = ("query_ranking", "linear_offset", "proj_v_off")


def dataset_builder(args, dataset_cfg):
    """(dataset, loader) for one split. The train split is shuffled by a
    seeded generator and drops its ragged last batch; batch size is
    ``others.bs``."""
    name = dataset_cfg.get("NAME")
    if name != "SyntheticPCN":
        raise NotImplementedError(
            f"dataset {name!r}: only SyntheticPCN (--synthetic) is ported; the PCN and "
            "ShapeNet readers wait for dataset files (ROADMAP Queue 1: dataset readers)"
        )
    dataset = SyntheticPCN(dataset_cfg)
    is_train = dataset_cfg.others.subset == "train"
    workers = int(getattr(args, "num_workers", 0))
    loader = DataLoader(
        dataset, batch_size=int(dataset_cfg.others.get("bs", 1)),
        shuffle=is_train, drop_last=is_train, num_workers=workers,
        generator=torch.Generator().manual_seed(int(getattr(args, "seed", 0))),
        persistent_workers=workers > 0,
    )
    return dataset, loader


def build_opt_sched(config, steps_per_epoch: int, model):
    """(optimizer, step -> lr, epoch -> BN momentum) for ``model``.

    The schedule is evaluated per optimizer step at the float epoch
    ``step / steps_per_epoch`` (imgadapointr_tpu/tools/builder.py:80-113);
    the caller writes the lr into the optimizer's parameter groups before
    each step."""
    opt_cfg = config.optimizer
    if opt_cfg.type != "AdamW":
        raise NotImplementedError(
            f"optimizer {opt_cfg.type}: only AdamW (the flagship's) is ported; Adam and SGD "
            "wait for the models that use them (ROADMAP Queue 1: baselines)"
        )
    if int(config.get("step_per_update", 1)) != 1:
        raise NotImplementedError(
            "step_per_update > 1 (gradient accumulation) is not ported "
            "(ROADMAP Queue 1: gradient accumulation)"
        )
    kwargs = opt_cfg.kwargs
    base_lr = float(kwargs.lr)
    lr_epoch = build_lr_schedule(base_lr, config.scheduler, int(config.get("max_epoch", 300)))
    decay = [p for p in model.parameters() if p.requires_grad and p.ndim > 1]
    no_decay = [p for p in model.parameters() if p.requires_grad and p.ndim <= 1]
    optimizer = torch.optim.AdamW(
        [{"params": decay, "weight_decay": float(kwargs.get("weight_decay", 0.0))},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=base_lr,
    )

    def lr_step(step: int) -> float:
        return lr_epoch(step / steps_per_epoch)

    return optimizer, lr_step, build_bnm_schedule(config.get("bnmscheduler", None))
