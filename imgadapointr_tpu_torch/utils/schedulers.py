"""Epoch-based schedules (learning rate, BatchNorm momentum) as plain
float functions of a float epoch.

Counterpart of ``imgadapointr_tpu/utils/schedulers.py:41-52`` and
``:96-143`` for the flagship's schedule types: ``LambdaLR`` (factor
``max(lr_decay ** ((e - warm) / decay_step), lowest_decay)`` with an
optional warm-up ramp ``max(e / warm, 0.001)``) and the BN-momentum Lambda
(``max(bn_momentum * bn_decay ** (e / decay_step), lowest_decay)``).
"""

from __future__ import annotations

# schedule type -> the ROADMAP item of the models that use it
_WAITING = {
    "StepLR": "ROADMAP Queue 1: baselines (GRNet)",
    "CosLR": "ROADMAP Queue 1: baselines",
    "GradualWarmup": "ROADMAP Queue 1: baselines (SnowFlakeNet)",
}


def lambda_lr_factor(epoch: float, lr_decay: float, decay_step: float,
                     lowest_decay: float, warmingup_e: float = 0) -> float:
    e = float(epoch)
    if warmingup_e > 0 and e < warmingup_e:
        return max(e / warmingup_e, 0.001)
    return max(lr_decay ** ((e - warmingup_e) / decay_step), lowest_decay)


def bn_momentum(epoch: float, bn_momentum: float = 0.9, bn_decay: float = 0.5,
                decay_step: float = 21, lowest_decay: float = 0.01) -> float:
    return max(bn_momentum * bn_decay ** (float(epoch) / decay_step), lowest_decay)


def build_lr_schedule(base_lr: float, sched_cfg, max_epoch: int):
    """``f(epoch) -> lr`` from a config ``scheduler`` block."""
    t = sched_cfg.type
    if t == "LambdaLR":
        k = sched_cfg.kwargs
        return lambda e: base_lr * lambda_lr_factor(
            e, k.lr_decay, k.decay_step, k.lowest_decay, k.get("warmingup_e", 0)
        )
    if t in _WAITING:
        raise NotImplementedError(f"scheduler type {t} is not ported yet ({_WAITING[t]})")
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
