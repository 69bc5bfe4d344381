"""Epoch-based schedules (learning rate, BatchNorm momentum) as plain
float functions of a float epoch.

Counterpart of ``imgadapointr_tpu/utils/schedulers.py:41-143``:

- ``LambdaLR``: factor ``max(lr_decay ** ((e - warm) / decay_step),
  lowest_decay)`` with an optional warm-up ramp ``max(e / warm, 0.001)``;
- ``StepLR``: factor ``gamma ** floor(e / step_size)`` (torch's StepLR);
- ``CosLR``: cosine decay from lr to ``min_lr`` over ``t_max - warmup``
  epochs after a linear warm-up from ``warmup_lr_init`` (timm's
  CosineLRScheduler as the reference uses it);
- ``GradualWarmup``: the lr ramps over ``total_epoch`` epochs (from 0 with
  multiplier 1, else from lr to lr * multiplier), then hands over to a
  StepLR at ``e - total_epoch`` (the reference GradualWarmupScheduler); the
  after-schedule comes as ``kwargs.after`` or, in ``SnowFlakeNet.yaml``'s
  form, as ``kwargs_1`` (the StepLR) and ``kwargs_2`` (the warm-up);
- the BN-momentum Lambda: ``max(bn_momentum * bn_decay ** (e / decay_step),
  lowest_decay)``.
"""

from __future__ import annotations

import math


def lambda_lr_factor(epoch: float, lr_decay: float, decay_step: float,
                     lowest_decay: float, warmingup_e: float = 0) -> float:
    e = float(epoch)
    if warmingup_e > 0 and e < warmingup_e:
        return max(e / warmingup_e, 0.001)
    return max(lr_decay ** ((e - warmingup_e) / decay_step), lowest_decay)


def bn_momentum(epoch: float, bn_momentum: float = 0.9, bn_decay: float = 0.5,
                decay_step: float = 21, lowest_decay: float = 0.01) -> float:
    return max(bn_momentum * bn_decay ** (float(epoch) / decay_step), lowest_decay)


def step_lr_factor(epoch: float, decay_step: float, gamma: float = 0.1) -> float:
    return gamma ** math.floor(float(epoch) / decay_step)


def cos_lr_value(epoch: float, t_max: float, lr: float, min_lr: float, warmup_e: float = 0,
                 warmup_lr_init: float = 1e-6) -> float:
    e = float(epoch)
    if e < warmup_e:
        return warmup_lr_init + (lr - warmup_lr_init) * e / max(warmup_e, 1)
    t = min(max((e - warmup_e) / max(t_max - warmup_e, 1), 0.0), 1.0)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * t))


def gradual_warmup_lr(epoch: float, base_lr: float, multiplier: float, total_epoch: float,
                      after_step_size: float | None = None, after_gamma: float = 0.1) -> float:
    """The lr at ``epoch``: the warm-up ramp up to ``total_epoch`` (no decay
    during it), then ``base_lr * multiplier`` under the after-StepLR at
    ``epoch - total_epoch``, or held without one."""
    e = float(epoch)
    if e <= total_epoch:
        if multiplier == 1.0:
            return base_lr * e / total_epoch
        return base_lr * (1.0 + (multiplier - 1.0) * min(max(e / total_epoch, 0.0), 1.0))
    if after_step_size is None:
        return base_lr * multiplier
    return base_lr * multiplier * after_gamma ** math.floor((e - total_epoch) / after_step_size)


def build_lr_schedule(base_lr: float, sched_cfg, max_epoch: int):
    """``f(epoch) -> lr`` from a config ``scheduler`` block."""
    t = sched_cfg.type
    if t == "GradualWarmup" and "kwargs_1" in sched_cfg:
        k1, k2 = sched_cfg.kwargs_1, sched_cfg.kwargs_2
        step_size, gamma = k1.get("step_size", 50), k1.get("gamma", 0.5)
        mult, total = k2.get("multiplier", 1.0), k2.get("total_epoch", 1)
        return lambda e: gradual_warmup_lr(e, base_lr, mult, total, step_size, gamma)
    k = sched_cfg.kwargs
    if t == "LambdaLR":
        return lambda e: base_lr * lambda_lr_factor(
            e, k.lr_decay, k.decay_step, k.lowest_decay, k.get("warmingup_e", 0)
        )
    if t == "StepLR":
        step_size = k.get("step_size", k.get("decay_step", 50))
        return lambda e: base_lr * step_lr_factor(e, step_size, k.get("gamma", 0.1))
    if t == "CosLR":
        t_max, min_lr, warm = k.get("t_max", max_epoch), k.get("min_lr", 1e-6), k.get("initial_epochs", 0)
        return lambda e: cos_lr_value(e, t_max, base_lr, min_lr, warm)
    if t == "GradualWarmup":
        after = k.get("after", None)
        mult, total = k.get("multiplier", 1.0), k.get("total_epoch", 1)
        if after is not None and after.type == "StepLR":
            ak = after.kwargs
            return lambda e: gradual_warmup_lr(e, base_lr, mult, total, ak.decay_step, ak.get("gamma", 0.1))
        return lambda e: gradual_warmup_lr(e, base_lr, mult, total)
    raise NotImplementedError(f"scheduler type {t}")


def build_bnm_schedule(bnm_cfg):
    """``f(epoch) -> torch-style BN momentum`` from a ``bnmscheduler`` block."""
    if bnm_cfg is None:
        return lambda e: 0.1  # torch BatchNorm default momentum
    k = bnm_cfg.kwargs
    return lambda e: bn_momentum(
        e, k.get("bn_momentum", 0.9), k.get("bn_decay", 0.5),
        k.get("decay_step", 21), k.get("lowest_decay", 0.01),
    )
