"""The reference's update: gradient-norm clip, AdamW and the PCN recipe's
schedules, in plain PyTorch.

Frozen copies of ``torch.nn.utils.clip_grad_norm_`` as the port calls it
(``imgadapointr_tpu_torch/parallel/mesh.py:clip_grad_norm`` on one rank),
``torch.optim.AdamW`` with decay on the parameters of more than one
dimension only (``tools/builder.py:build_opt_sched``), and the LambdaLR and
BN-momentum schedules (``utils/schedulers.py``), each written out per leaf.
"""

from __future__ import annotations

import math

import torch


def lambda_lr(epoch: float, base_lr: float, lr_decay: float, decay_step: float, lowest_decay: float) -> float:
    return base_lr * max(lr_decay ** (float(epoch) / decay_step), lowest_decay)


def bn_momentum(epoch: float, bn_momentum: float, bn_decay: float, decay_step: float, lowest_decay: float) -> float:
    return max(bn_momentum * bn_decay ** (float(epoch) / decay_step), lowest_decay)


def schedules(cfg: dict):
    """(update -> lr given updates an epoch, epoch -> BN momentum) of a config."""
    if cfg["optimizer"]["type"] != "AdamW" or cfg["scheduler"]["type"] != "LambdaLR":
        raise ValueError("the reference takes AdamW under LambdaLR")
    k = cfg["scheduler"]["kwargs"]
    base = float(cfg["optimizer"]["kwargs"]["lr"])
    b = cfg["bnmscheduler"]["kwargs"]

    def lr(update: int, updates_per_epoch: float) -> float:
        return lambda_lr(update / updates_per_epoch, base, k["lr_decay"], k["decay_step"], k["lowest_decay"])

    def bnm(epoch: float) -> float:
        return bn_momentum(epoch, b.get("bn_momentum", 0.9), b.get("bn_decay", 0.5), b.get("decay_step", 21),
                           b.get("lowest_decay", 0.01))

    return lr, bnm


@torch.no_grad()
def clip(grads: list, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a total norm of at most ``max_norm``;
    return the norm before the clip."""
    total = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


class AdamW:
    """Per-leaf AdamW (betas 0.9, 0.999, eps 1e-8), decoupled decay on
    leaves of more than one dimension; a leaf without a gradient is skipped."""

    def __init__(self, params: dict, weight_decay: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.wd, self.betas, self.eps = params, weight_decay, betas, eps
        self.state: dict = {}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        b1, b2 = self.betas
        for name, p in self.params.items():
            g = grads.get(name)
            if g is None:
                continue
            s = self.state.setdefault(name, {"t": 0, "m": torch.zeros_like(p), "v": torch.zeros_like(p)})
            s["t"] += 1
            if p.ndim > 1:
                p.mul_(1.0 - lr * self.wd)
            s["m"].mul_(b1).add_(g, alpha=1 - b1)
            s["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (s["v"].sqrt() / math.sqrt(1 - b2 ** s["t"])).add_(self.eps)
            p.addcdiv_(s["m"], denom, value=-lr / (1 - b1 ** s["t"]))
