"""Training / validation / test harness of the PCN protocol.

Counterpart of ``imgadapointr_tpu/tools/runner.py:94-428`` (the step
functions) and ``:432-833`` (``run_net``, ``validate``, ``test_net``,
``test``), single device, eager PyTorch. Every model trains with its own
loss (``model.loss``); ``test`` runs the PCN protocol with the auction EMD
unless ``--no_emd``. The ShapeNet-55 and KITTI test protocols, gradient
accumulation and multi-GPU wait (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..models import build_model
from ..ops import nn_distance
from ..ops.chamfer import _sqrt_floor
from ..utils.average_meter import AverageMeter
from ..utils.checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from ..utils.logger import print_log
from ..utils.metrics import METRIC_NAMES, Metrics, compute_metrics, eval_metric_suite
from .builder import ZERO_GRAD_PARAM_MARKERS, build_opt_sched, dataset_builder
from .convert import fit_reference_state, load_gdanet_weights, load_reference_state

SHAPENET_DICT_PATH = os.path.join("cfgs", "shapenet_synset_dict.json")
EVAL_KEYS = ("sparse_l1", "sparse_l2", "dense_l1", "dense_l2", "f_score")


class Runner:
    """Owns the model, the optimizer, the schedules and the step functions."""

    def __init__(self, args, config, logger=None):
        self.args = args
        self.config = config
        self.logger = logger
        self.device = resolve_device(getattr(args, "device", "cuda"))
        seed = int(getattr(args, "seed", 0))
        self.model = build_model(config.model, device=self.device, seed=seed)
        if getattr(args, "gdanet_w", None):
            load_gdanet(self.model, args.gdanet_w, logger)
        self.consider_metric = config.get("consider_metric", "CDL1")
        self.grad_clip = float(config.get("grad_norm_clip", 10.0))
        # the denoise jitter's stream, on the model's device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = None
        self.step = 0  # optimizer steps taken
        n_params = sum(p.numel() for p in self.model.parameters())
        print_log(f"Model {config.model.NAME}: {n_params / 1e6:.2f}M params on {self.device}", logger)

    def make_train_state(self, steps_per_epoch: int) -> None:
        self.steps_per_epoch = steps_per_epoch
        self.optimizer, self.lr_sched, self.bnm_sched = build_opt_sched(
            self.config, steps_per_epoch, self.model
        )

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _inputs(self, batch: dict) -> list:
        """The batch entries the model takes (``model.inputs``), in order."""
        return [batch[k] for k in self.model.inputs]

    # ------------------------------------------------------------- train step
    def train_step(self, batch: dict, epoch_f: float, noise: torch.Tensor | None = None) -> dict:
        """One optimizer step on ``batch`` (the model's inputs and 'gt'):
        forward in train mode with the scheduled BN momentum, the model's
        own loss at the float epoch ``epoch_f``, backward, clip, AdamW at
        the scheduled lr. Returns device scalars (no synchronisation):
        sparse_loss, dense_loss, total_loss, grad_norm (the clip's norm,
        before the clip, over the parameters with a gradient: a frozen
        GDANet's flow-through gradients stay out) and the float lr.
        ``noise`` fixes the denoise jitter's standard-normal draw."""
        batch = self._to_device(batch)
        self.model.train()
        lr = self.lr_sched(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        ret = self.model(*self._inputs(batch), bn_momentum=self.bnm_sched(epoch_f),
                         generator=self.generator, noise=noise)
        sparse, dense = self.model.loss(ret, batch["gt"], epoch_f)
        total = sparse + dense
        total.backward()
        for name, p in self.model.named_parameters():
            if p.grad is not None and any(m in name for m in ZERO_GRAD_PARAM_MARKERS):
                raise RuntimeError(f"{name} got a gradient: it must stay out of the graph")
        # torch's rule is the reference's: coef = min(max_norm / (norm + 1e-6), 1)
        trainable = [p for p in self.model.parameters() if p.requires_grad]
        grad_norm = torch.nn.utils.clip_grad_norm_(trainable, self.grad_clip)
        self.optimizer.step()
        self.step += 1
        return {"sparse_loss": sparse.detach(), "dense_loss": dense.detach(),
                "total_loss": total.detach(), "grad_norm": grad_norm, "lr": lr}

    # -------------------------------------------------------------- eval steps
    @torch.inference_mode()
    def _eval_core(self, batch: dict):
        """(B, 5) per-sample metrics in EVAL_KEYS order and the (coarse,
        dense) clouds: one nearest-neighbour pass per cloud pair."""
        self.model.eval()
        coarse, dense = self.model(*self._inputs(batch))
        gt = batch["gt"]
        d1, d2, _, _ = nn_distance(coarse, gt)
        sparse_l1 = (_sqrt_floor(d1).mean(dim=1) + _sqrt_floor(d2).mean(dim=1)) / 2.0 * 1000.0
        sparse_l2 = (d1.mean(dim=1) + d2.mean(dim=1)) * 1000.0
        f, l1, l2 = eval_metric_suite(dense, gt, reduce=False)
        return torch.stack([sparse_l1, sparse_l2, l1, l2, f], dim=1), (coarse, dense)

    def eval_step(self, batch: dict) -> np.ndarray:
        """(B, 5) per-sample metric rows on the host, EVAL_KEYS order."""
        return self._eval_core(self._to_device(batch))[0].double().cpu().numpy()

    @torch.inference_mode()
    def test_step(self, batch: dict, require_emd: bool = True) -> np.ndarray:
        """(B, 9) rows: EVAL_KEYS, then the reference's Metrics row. At
        batch size 1 its CDs drop zero-padded rows (the reference's
        ``ignore_zeros`` engages only there), which takes the masked
        nearest-neighbour path; the F-Score is the eval suite's; EMD x1000
        is the auction's (eps 0.005, 100 iterations), 0 unless
        ``require_emd``."""
        batch = self._to_device(batch)
        rows, (_, dense) = self._eval_core(batch)
        vals = compute_metrics(dense, batch["gt"], require_emd=require_emd,
                               ignore_zeros=dense.shape[0] == 1, f_value=rows[:, 4].mean())
        protocol = torch.stack([v.to(rows.dtype) for v in vals]).expand(rows.shape[0], -1)
        return torch.cat([rows, protocol], dim=1).double().cpu().numpy()

    # ------------------------------------------------------------- checkpoints
    def save(self, prefix: str, epoch: int, metrics, best_metrics) -> str:
        return save_checkpoint(
            self.model, self.optimizer, epoch, self.step,
            metrics.state_dict() if metrics else None,
            best_metrics.state_dict() if best_metrics else None,
            prefix, self.args.experiment_path, self.logger,
        )

    def load_weights(self, path: str) -> None:
        """Weights only, from a checkpoint of this runner or a
        reference-layout ``.pth``; optimizer and schedules stay fresh."""
        sd = fit_reference_state(load_reference_state(path), self.model)
        self.model.load_state_dict(sd, strict=True)


def load_gdanet(model, path: str, logger=None) -> None:
    """``--gdanet_w``: a reference GDANet checkpoint into the model's frozen
    ``segmentator`` (reference tools/runner.py:55-66, ``strict=False``);
    raises when nothing matches or the model has no GDANet."""
    gdanet = getattr(model.base_model, "segmentator", None)
    if gdanet is None:
        raise ValueError(f"--gdanet_w: {type(model).__name__} has no GDANet")
    missing = load_gdanet_weights(path, gdanet)
    print_log(f"GDANet weights loaded from {path}"
              + (f"; {len(missing)} keys kept their init: {missing[:5]}" if missing else ""), logger)


# ---------------------------------------------------------------------- train
def run_net(args, config) -> Runner:
    logger = getattr(args, "logger", None)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, val_loader = dataset_builder(args, config.dataset.val)
    runner = Runner(args, config, logger)
    steps_per_epoch = max(len(train_loader), 1)
    runner.make_train_state(steps_per_epoch)

    start_epoch, best_metrics = 0, None
    last = checkpoint_path("ckpt-last", args.experiment_path)
    if getattr(args, "resume", False) and os.path.exists(last):
        meta = load_checkpoint(last, runner.model, runner.optimizer)
        start_epoch = int(meta["epoch"]) + 1
        runner.step = int(meta["step"])
        if meta["best_metrics"]:
            best_metrics = Metrics(runner.consider_metric, meta["best_metrics"])
        print_log(f"Resumed from epoch {start_epoch}", logger)
    elif getattr(args, "start_ckpts", None):
        runner.load_weights(args.start_ckpts)
        print_log(f"Warm-start weights loaded from {args.start_ckpts} "
                  "(fresh optimizer/schedules)", logger)

    max_epoch = int(config.max_epoch)
    seed = int(getattr(args, "seed", 0))
    for epoch in range(start_epoch, max_epoch):
        # the epoch's order depends on (seed, epoch) only, so a resumed run
        # sees the batches an uninterrupted one would
        train_loader.generator.manual_seed(seed * 100003 + epoch)
        losses = AverageMeter(["SparseLoss", "DenseLoss"])
        step_losses = []  # device scalars, fetched once at the epoch's end
        epoch_start = t0 = time.time()
        n_batches = len(train_loader)
        for idx, (_, _, batch) in enumerate(train_loader):
            m = runner.train_step(batch, epoch + idx / steps_per_epoch)
            step_losses.append(torch.stack([m["sparse_loss"], m["dense_loss"]]))
            if idx % 100 == 0:  # the only host synchronisation inside an epoch
                sparse, dense = (float(v) * 1000 for v in step_losses[-1])
                losses.update([sparse, dense])
                print_log(
                    f"[Epoch {epoch}/{max_epoch}][Batch {idx + 1}/{n_batches}] "
                    f"BatchTime = {time.time() - t0:.3f}s "
                    f"Losses = {['%.4f' % v for v in losses.val()]} lr = {m['lr']:.6f}",
                    logger,
                )
            t0 = time.time()
        if step_losses:
            ep = (torch.stack(step_losses).mean(dim=0) * 1000).tolist()
        else:
            ep = losses.avg()
        print_log(
            f"[Training] EPOCH: {epoch} EpochTime = {time.time() - epoch_start:.3f}s "
            f"Losses = {['%.4f' % v for v in ep]}", logger,
        )

        if epoch % int(getattr(args, "val_freq", 1)) == 0:
            metrics = validate(runner, val_loader, epoch, logger)
            if metrics.better_than(best_metrics):
                best_metrics = metrics
                runner.save("ckpt-best", epoch, metrics, best_metrics)
        runner.save("ckpt-last", epoch, None, best_metrics)
        if epoch > max_epoch - 2:
            runner.save(f"ckpt-epoch-{epoch:03d}", epoch, None, best_metrics)
    return runner


# ------------------------------------------------------------------- validate
def _accumulate(category_metrics: dict, taxonomy_ids, rows) -> None:
    for tax, row in zip(taxonomy_ids, rows):
        category_metrics.setdefault(tax, AverageMeter(METRIC_NAMES)).update([float(v) for v in row])


def _overall(category_metrics: dict) -> np.ndarray:
    """Mean of the per-category means (reference tools/runner.py:410-411)."""
    if not category_metrics:
        return np.zeros(len(METRIC_NAMES))
    return np.array([am.avg() for am in category_metrics.values()]).mean(axis=0)


def validate(runner: Runner, val_loader, epoch: int, logger=None) -> Metrics:
    print_log(f"[VALIDATION] Start validating epoch {epoch}", logger)
    category_metrics: dict[str, AverageMeter] = {}
    for taxonomy_ids, _, batch in val_loader:
        rows = runner.eval_step(batch)
        # [F-Score, CDL1, CDL2, EMD] of the dense cloud; EMD is not validated
        _accumulate(category_metrics, taxonomy_ids,
                    np.concatenate([rows[:, [4, 2, 3]], np.zeros((len(rows), 1))], axis=1))
    overall = _overall(category_metrics)
    print_log("[Validation] EPOCH: %d Metrics = %s" % (epoch, ["%.4f" % v for v in overall]), logger)
    for tax, am in sorted(category_metrics.items()):
        print_log(f"  {tax}: {['%.4f' % v for v in am.avg()]}", logger)
    return Metrics(runner.consider_metric, list(overall))


# ----------------------------------------------------------------------- test
def test_net(args, config) -> dict:
    logger = getattr(args, "logger", None)
    print_log("Tester start ...", logger)
    if not getattr(args, "ckpts", None):
        # evaluating a random init silently would produce a garbage table
        raise ValueError("test_net requires --ckpts (refusing to test a random init)")
    _, test_loader = dataset_builder(args, config.dataset.test)
    runner = Runner(args, config, logger)
    runner.load_weights(args.ckpts)
    return test(runner, test_loader, args, config, logger)


def _load_shapenet_dict() -> dict:
    """Taxonomy id -> name; like the configs' ``_base_`` includes, the path
    is relative to the working directory, and a missing file raises."""
    with open(SHAPENET_DICT_PATH) as f:
        return json.load(f)


def test(runner: Runner, test_loader, args, config, logger=None) -> dict:
    """The PCN test protocol: per-taxonomy and overall F-Score, CD-L1,
    CD-L2 and EMD (x1000); EMD reads 0 with ``--no_emd``."""
    name = config.dataset.test.get("NAME", "")
    if name == "KITTI" or ("ShapeNet" in name and "PCN" not in name):
        raise NotImplementedError(
            f"test protocol of {name} is not ported (ROADMAP Queue 1: multi-GPU and protocols)"
        )
    require_emd = bool(getattr(args, "emd", True))
    print_log(f"[TEST] PCN protocol; EMD {'on' if require_emd else 'off (--no_emd)'}", logger)
    category_metrics: dict[str, AverageMeter] = {}
    for taxonomy_ids, _, batch in test_loader:
        rows = runner.test_step(batch, require_emd=require_emd)
        _accumulate(category_metrics, taxonomy_ids, rows[:, 5:])
    overall = _overall(category_metrics)

    shapenet_dict = _load_shapenet_dict()
    print_log("============================ TEST RESULTS ============================", logger)
    print_log("Taxonomy\t#Sample\t" + "\t".join(METRIC_NAMES) + "\t#ModelName", logger)
    for tax, am in sorted(category_metrics.items()):
        print_log(f"{tax}\t{am.count(0)}\t" + "\t".join("%.4f" % v for v in am.avg())
                  + "\t" + shapenet_dict.get(tax, tax), logger)
    print_log("Overall\t\t" + "\t".join("%.4f" % v for v in overall), logger)
    return dict(zip(METRIC_NAMES, overall))
