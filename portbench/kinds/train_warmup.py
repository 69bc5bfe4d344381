"""The ``train_warmup`` kind: :mod:`.train`'s ``Train`` (its feed, window,
checked steps and gaps unchanged) for a recipe of Adam under GradualWarmup
with no BN-momentum schedule (SnowFlakeNet's). The reference's update is
Adam with weight decay 0, which is :class:`~..reference.optim.AdamW` with
decay 0 exactly; its lr is :mod:`..reference.warmup`'s, read per update (the
first update's lr is 0), its BN momentum 0.1; the clip is the recipe's
``grad_norm_clip``, else the runner's 10.

``run.py`` counts a cloud's backward into ``mfu`` for the kind ``train``
alone, so this kind hands it the model's training-step count whatever it
asks for.
"""

from __future__ import annotations

import types

from ..reference import optim as ref_optim
from ..reference import warmup
from ..workloads import free, tf32
from .train import Train


class TrainWarmup(Train):
    """``Train`` with the reference's update under GradualWarmup."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        net = self.net
        self.net = types.SimpleNamespace(INPUTS=net.INPUTS, build=net.build, sample=net.sample,
                                         step_flops=lambda cfg, n_points, train: net.step_flops(cfg, n_points, True))

    def reference_steps(self, batches: list, control: bool = False) -> dict:
        """As ``Train.reference_steps``, under :func:`..reference.warmup.schedules`."""
        model = self.reference()
        model.train()
        lr_of, bnm_of = warmup.schedules(self.run_cfg)
        if self.run_cfg["optimizer"]["type"] != "Adam":
            raise ValueError("the train_warmup kind takes Adam")
        params = dict(model.named_parameters())
        opt = ref_optim.AdamW({n: p for n, p in params.items() if p.requires_grad},
                              float(self.run_cfg["optimizer"]["kwargs"].get("weight_decay", 0.0)))
        if opt.wd:
            raise ValueError("Adam's weight decay is coupled; the reference takes it at 0 only")
        clip_norm = float(self.run_cfg.get("grad_norm_clip", 10.0))
        losses, grad1 = [], None
        theta0 = {n: p.detach().clone() for n, p in params.items()}
        for i, (epoch_f, batch) in enumerate(batches):
            batch = {k: v.to(self.device) for k, v in batch.items()}
            with tf32(control):
                ret = model(*[batch[k] for k in self.inputs], bn_momentum=bnm_of(epoch_f),
                            noise=self.noise[i % len(self.noise)])
                sparse, dense = model.loss(ret, batch["gt"], epoch_f)
                model.zero_grad(set_to_none=True)
                (sparse + dense).backward()
            losses.append((sparse.item(), dense.item()))
            grads = {n: p.grad for n, p in params.items() if p.grad is not None}
            ref_optim.clip(list(grads.values()), clip_norm)
            if i == 0:
                grad1 = {n: float(g.norm()) for n, g in grads.items()}
            opt.step(grads, lr_of(i, self.steps_per_epoch))
        change = {n: float((p.detach() - theta0[n]).norm()) for n, p in params.items()}
        del model, params, opt
        free()
        return {"losses": losses, "grad1": grad1, "change": change}


KIND = TrainWarmup
