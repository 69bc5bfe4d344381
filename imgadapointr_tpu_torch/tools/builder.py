"""Factories: data loaders, optimizer, schedules.

Counterpart of ``imgadapointr_tpu/tools/builder.py`` for the shipped
recipes: ``torch.optim.AdamW`` with weight decay on the parameters of
more than one dimension only (biases and norm scales decay nothing,
reference ``add_weight_decay``), ``Adam`` and ``SGD`` with torch's coupled
L2, the learning rate set before every optimizer update from the epoch
schedule (:func:`build_opt_sched`). A frozen subtree (GDANet in the
segmentation models, whose parameters have ``requires_grad`` off) is in no
group, as the reference's ``requires_grad=False`` keeps it out
(``imgadapointr_tpu/tools/builder.py:166-178``).
"""

from __future__ import annotations

import torch

from ..datasets import DATASETS, Loader
from ..utils.schedulers import build_bnm_schedule, build_lr_schedule

# Parameter subtrees that get no gradient by construction: the query-ranking
# MLP (only the indices of its sorted scores are used) and the deformable
# offset nets. Their ``grad`` stays None after a backward, so AdamW skips
# them: no decay, no moments (imgadapointr_tpu/tools/builder.py:46-55).
ZERO_GRAD_PARAM_MARKERS = ("query_ranking", "linear_offset", "proj_v_off")


def dataset_builder(args, dataset_cfg):
    """(dataset, loader) for one split: the reader ``DATASETS`` registers
    under the config's ``NAME`` and a :class:`Loader` over it in the JAX
    loader's order (``--seed``). The train split is shuffled and drops its
    ragged last batch; the batch size is ``others.bs``; ``--num_workers``
    workers of ``--worker_mode`` (threads by default)."""
    dataset = DATASETS.build(dataset_cfg)
    is_train = dataset_cfg.others.subset == "train"
    loader = Loader(dataset, batch_size=int(dataset_cfg.others.get("bs", 1)), shuffle=is_train,
                    drop_last=is_train, seed=int(getattr(args, "seed", 0)),
                    num_workers=int(getattr(args, "num_workers", 0)),
                    worker_mode=getattr(args, "worker_mode", "thread"))
    return dataset, loader


def build_opt_sched(config, steps_per_epoch: int, model):
    """(optimizer, update -> lr, epoch -> BN momentum) for ``model``.

    ``AdamW`` decays the parameters of more than one dimension only
    (decoupled); ``Adam`` and ``SGD`` (``momentum``, ``nesterov`` from the
    config's kwargs) add the coupled L2 term ``weight_decay * p`` to the
    gradient of every trainable parameter, 1-D ones too, after the clip
    (torch's own ``weight_decay``; ``imgadapointr_tpu/tools/builder.py:137-163``).
    A parameter whose ``grad`` stays None (a frozen subtree, the zero-grad
    markers) is skipped by all three: no decay, no moments.

    With ``step_per_update: k`` the runner sums k backward passes and steps
    once, so an epoch holds ``steps_per_epoch / k`` updates; the schedule is
    evaluated per optimizer update at the float epoch ``update /
    (steps_per_epoch / k)`` (the JAX package's ``lr_update``,
    ``imgadapointr_tpu/tools/builder.py:107-114``). The caller writes the lr
    into the optimizer's parameter groups before each update."""
    opt_cfg = config.optimizer
    kwargs = opt_cfg.kwargs
    base_lr = float(kwargs.lr)
    wd = float(kwargs.get("weight_decay", 0.0))
    lr_epoch = build_lr_schedule(base_lr, config.scheduler, int(config.get("max_epoch", 300)))
    k = int(config.get("step_per_update", 1))
    if k < 1:
        raise ValueError(f"step_per_update must be >= 1, got {k}")
    trainable = [p for p in model.parameters() if p.requires_grad]
    if opt_cfg.type == "AdamW":
        optimizer = torch.optim.AdamW(
            [{"params": [p for p in trainable if p.ndim > 1], "weight_decay": wd},
             {"params": [p for p in trainable if p.ndim <= 1], "weight_decay": 0.0}],
            lr=base_lr,
        )
    elif opt_cfg.type == "Adam":
        optimizer = torch.optim.Adam(trainable, lr=base_lr, weight_decay=wd)
    elif opt_cfg.type == "SGD":
        momentum = float(kwargs.get("momentum", 0.0))
        # optax drops nesterov without momentum; torch refuses the pair
        nesterov = bool(kwargs.get("nesterov", False)) and momentum > 0
        optimizer = torch.optim.SGD(trainable, lr=base_lr, momentum=momentum, nesterov=nesterov,
                                    weight_decay=wd)
    else:
        raise NotImplementedError(f"optimizer {opt_cfg.type}")
    updates_per_epoch = steps_per_epoch / k

    def lr_update(update: int) -> float:
        return lr_epoch(update / updates_per_epoch)

    return optimizer, lr_update, build_bnm_schedule(config.get("bnmscheduler", None))
