"""The update schedules of a recipe under GradualWarmup (SnowFlakeNet's
``cfgs/PCN_models/SnowFlakeNet.yaml``), in plain Python.

The lr of ildoonet's ``GradualWarmupScheduler`` as PoinTr builds it from
``kwargs_2`` (``multiplier``, ``total_epoch``) with a StepLR after it from
``kwargs_1`` (``step_size``, ``gamma``): over the first ``total_epoch``
epochs the lr ramps from 0 to ``base`` (multiplier 1) or from ``base`` to
``base * multiplier``; after them it is ``base * multiplier`` times ``gamma``
every ``step_size`` epochs past ``total_epoch``. It is read at the float
epoch of each update (``update / updates_per_epoch``), as the port's
``tools/builder.py:build_opt_sched`` reads it. A recipe with no
``bnmscheduler`` keeps torch's BatchNorm momentum, 0.1.
"""

from __future__ import annotations

import math

BN_MOMENTUM = 0.1


def gradual_warmup_lr(epoch: float, base: float, multiplier: float, total_epoch: float, step_size: float,
                      gamma: float) -> float:
    e = float(epoch)
    if e <= total_epoch:
        if multiplier == 1.0:
            return base * e / total_epoch
        return base * ((multiplier - 1.0) * e / total_epoch + 1.0)
    return base * multiplier * gamma ** math.floor((e - total_epoch) / step_size)


def schedules(cfg: dict):
    """(update -> lr given updates an epoch, epoch -> BN momentum) of a
    config under GradualWarmup with its after-StepLR."""
    sched = cfg["scheduler"]
    if sched["type"] != "GradualWarmup" or "bnmscheduler" in cfg:
        raise ValueError("the reference takes GradualWarmup (kwargs_1, kwargs_2) and no BN-momentum schedule")
    after, warm = sched["kwargs_1"], sched["kwargs_2"]
    base = float(cfg["optimizer"]["kwargs"]["lr"])

    def lr(update: int, updates_per_epoch: float) -> float:
        return gradual_warmup_lr(update / updates_per_epoch, base, float(warm["multiplier"]),
                                 float(warm["total_epoch"]), float(after["step_size"]), float(after["gamma"]))

    def bnm(epoch: float) -> float:
        return BN_MOMENTUM

    return lr, bnm
