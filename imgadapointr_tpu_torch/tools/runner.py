"""Training / validation / test harness.

Counterpart of ``imgadapointr_tpu/tools/runner.py:94-428`` (the step
functions) and ``:432-933`` (``run_net``, ``validate``, ``test_net``,
``test`` and its protocols), single device, eager PyTorch. Every model
trains with its own loss (``model.loss``) after the recipe's train
augmentation (``train_aug``: the ShapeNet-55 crop, the KITTI-finetune
dropping, or none). ``test`` runs the PCN protocol with the auction EMD
unless ``--no_emd``, the ShapeNet-55 8-viewpoint crop protocol
(``--mode``) or the KITTI visualisation. ``step_per_update: k`` sums k
batches' gradients into one optimizer update.

``--ckpts``, ``--start_ckpts`` and ``--resume`` read the JAX package's
``.ckpt`` files as well as the port's ``.pth`` (``--resume`` continues a
JAX run from its ``ckpt-last.ckpt`` when the experiment has no
``ckpt-last.pth``: weights, BN statistics, optimizer state and step from
the payload, epoch and best metrics from the sidecar). ``run_net`` also
takes the JAX runner's ``--profile`` (a ``torch.profiler`` chrome trace
into ``tfboard_path``, started before step 1 of the first epoch and
stopped before step 6, as the JAX runner's window), its TensorBoard scalars (the
writers ``main`` makes), ``--wandb`` and the RSS watchdog
(``IMGADAPOINTR_RSS_LIMIT_GB``; ``imgadapointr_tpu/tools/runner.py:40-76``,
``:467-640``).

Several processes (``torchrun``, ``main.py --launcher pytorch``) run one
train step together over a ``(dp, tp, sp)`` mesh (``parallel/mesh.py``):
the state starts from rank 0's init, the data-parallel update all-reduces
the gradients (no ``DistributedDataParallel``), BatchNorm takes the global
batch's moments, every draw shaped by the batch is drawn at the global
batch's shape and sliced (``parallel/dist.py:global_draw``), ``--tp``
column-shards the large weights, ``--sp`` runs the chamfer losses on the
point axis (``ops/chamfer.py:points_axis_sharding``), and rank 0 alone
writes checkpoints, logs and scalars.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..datasets.loader import LOADER_COUNTERS
from ..models import build_model
from ..ops import fps, mxu_eval_chamfer_active, nn_distance, random_dropping, separate_point_cloud, train_random_crop
from ..ops.chamfer import _sqrt_floor, points_axis_sharding
from ..parallel.dist import data_parallel
from ..parallel.mesh import (TensorParallel, broadcast_state, clip_grad_norm, make_mesh, reduce_gradients,
                             reduce_max, reduce_mean, reduce_tensors)
from ..utils import render, trace
from ..utils.average_meter import AverageMeter
from ..utils.checkpoint import checkpoint_path, load_checkpoint, load_jax_checkpoint, save_checkpoint
from ..utils.device import deterministic_cudnn, resolve_device
from ..utils.logger import print_log
from ..utils.metrics import METRIC_NAMES, Metrics, compute_metrics_per_sample, eval_metric_suite, f_score
from .builder import ZERO_GRAD_PARAM_MARKERS, build_opt_sched, dataset_builder
from .convert import (load_flax_weights, load_gdanet_weights, load_weights, optimizer_state_from_optax,
                      pending_grads_from_optax)

SHAPENET_DICT_PATH = os.path.join("cfgs", "shapenet_synset_dict.json")
EVAL_KEYS = ("sparse_l1", "sparse_l2", "dense_l1", "dense_l2", "f_score")
# ShapeNet-55 protocol: the share of a cloud each mode crops, and the 8
# corner viewpoints, used as they are (imgadapointr_tpu/tools/runner.py:767-774)
CROP_RATIO = {"easy": 1 / 4, "median": 1 / 2, "hard": 3 / 4}
SHAPENET55_VIEWPOINTS = [
    (1, 1, 1), (1, 1, -1), (1, -1, 1), (-1, 1, 1),
    (-1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1),
]
CROP_INPUT_POINTS = 2048  # a crop's input to the model, by FPS
RSS_RESTART_EXIT_CODE = 75  # EX_TEMPFAIL: relaunch with --resume
PROFILE_WINDOW = (1, 6)  # --profile traces train steps 1-5 of the first epoch, as JAX's (1, 6)


def _proc_status() -> str:
    """The text of ``/proc/self/status`` ('' where it is missing)."""
    try:
        with open("/proc/self/status") as f:
            return f.read()
    except OSError:
        return ""


def host_rss_gb() -> float:
    """The process's current resident set in GB: ``VmRSS`` of
    ``/proc/self/status`` (in kB), 0 where the line is missing. The JAX
    package reads the peak (``ru_maxrss``, the status file's ``VmHWM``), so
    one spike kept every later epoch over the limit."""
    for line in _proc_status().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1e6
    return 0.0


def rss_limit_gb() -> float:
    """The RSS watchdog's limit in GB: ``IMGADAPOINTR_RSS_LIMIT_GB`` (0
    turns it off), else 0.75 of the host's ``MemTotal``, else 0
    (``imgadapointr_tpu/tools/runner.py:49-76``). At an epoch's end, after
    ``ckpt-last``, a run whose RSS is above it exits with
    ``RSS_RESTART_EXIT_CODE`` so that a supervisor relaunches it with
    ``--resume``."""
    raw = os.environ.get("IMGADAPOINTR_RSS_LIMIT_GB")
    if raw is not None:
        return float(raw)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return 0.75 * int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def select_train_aug(config) -> tuple[str, int]:
    """(train augmentation, its gt size) of a config, as the JAX runner
    selects them (``imgadapointr_tpu/tools/runner.py:111-140``):
    ``dataset.train.train_aug`` (``crop``, ``dropping`` or ``none``; the
    bare key means ``none``), else ``crop`` for a ShapeNet reader,
    ``dropping`` with ``CARS``, else ``none``. The size is the split's
    ``N_POINTS`` (default 8192)."""
    dataset = config.get("dataset")
    train_cfg = dataset.get("train") if dataset else None
    base = (train_cfg.get("_base_") or train_cfg) if train_cfg else None
    aug = train_cfg.get("train_aug") if train_cfg else None
    if aug is None and train_cfg is not None and "train_aug" in train_cfg:
        aug = "none"
    if aug is None and base is not None:
        name = base.get("NAME", "")
        if "ShapeNet" in name and "PCN" not in name:
            aug = "crop"
        elif base.get("CARS", False):
            aug = "dropping"
    aug = aug or "none"
    if aug not in ("crop", "dropping", "none"):
        raise ValueError(f"dataset.train.train_aug must be crop|dropping|none, got {aug!r}")
    return aug, int(base.get("N_POINTS", 8192)) if base else 0


class Runner:
    """Owns the model, the optimizer, the schedules and the step functions."""

    def __init__(self, args, config, logger=None):
        self.args = args
        self.config = config
        self.logger = logger
        self.device = resolve_device(getattr(args, "device", "cuda"))
        seed = int(getattr(args, "seed", 0))
        # the (dp, tp, sp) mesh of the initialised process group, or one process's
        self.mesh = make_mesh(int(getattr(args, "tp", 1) or 1), int(getattr(args, "sp", 1) or 1))
        self.model = build_model(config.model, device=self.device, seed=seed)
        if getattr(args, "gdanet_w", None):
            load_gdanet(self.model, args.gdanet_w, logger)
        broadcast_state(self.model, self.mesh.world)  # one init on every rank
        self.tp = TensorParallel(self.model, config.model, self.mesh)
        self.consider_metric = config.get("consider_metric", "CDL1")
        self.grad_clip = float(config.get("grad_norm_clip", 10.0))
        self.train_aug, self.train_npoints = select_train_aug(config)
        # the train augmentation's and the denoise jitter's stream, on the model's
        # device, seeded alike on every rank (the draws are the global batch's)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = None
        self.step = 0  # train steps (batches) taken
        self.predicts = 0  # predict calls made (the unit of their spans)
        # batches whose gradients one optimizer update sums
        self.step_per_update = int(config.get("step_per_update", 1))
        n_params = sum(p.numel() for p in self.model.parameters())
        print_log(f"Model {config.model.NAME}: {n_params / 1e6:.2f}M params on {self.device}", logger)

    def make_train_state(self, steps_per_epoch: int) -> None:
        self.steps_per_epoch = steps_per_epoch
        self.optimizer, self.lr_sched, self.bnm_sched = build_opt_sched(
            self.config, steps_per_epoch, self.model
        )

    def _local_rows(self, t: torch.Tensor | None, batch_size: int) -> torch.Tensor | None:
        """This data rank's rows of a draw given at the global batch's size."""
        dp, d = self.mesh.dp, self.mesh.coords[0]
        if t is None or dp == 1 or t.shape[0] != batch_size * dp:
            return t
        return t[d * batch_size:(d + 1) * batch_size]

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _inputs(self, batch: dict) -> list:
        """The batch entries the model takes (``model.inputs``), in order."""
        return [batch[k] for k in self.model.inputs]

    # ------------------------------------------------------------- train step
    def augment(self, batch: dict, epoch_f: float, draws: dict | None = None) -> dict:
        """The recipe's train augmentation of a batch on the device: the
        ShapeNet-55 crop makes ``partial`` from ``gt`` (``train_npoints``
        points a cloud, FPS to 2048); the KITTI-finetune dropping thins
        ``partial`` at the epoch ``floor(epoch_f)``. ``draws`` fixes the
        augmentation's draws (``center`` and ``num_crop``, or ``keep_n``)."""
        draws = draws or {}
        with torch.no_grad():  # no gradient reaches the augmentation
            if self.train_aug == "crop":
                return dict(batch, partial=train_random_crop(batch["gt"], self.train_npoints,
                                                             generator=self.generator, **draws))
            if self.train_aug == "dropping":
                return dict(batch, partial=random_dropping(batch["partial"], math.floor(epoch_f),
                                                           generator=self.generator, **draws))
        return batch

    def train_step(self, batch: dict, epoch_f: float, noise: torch.Tensor | None = None,
                   aug: dict | None = None) -> dict:
        """One train step on ``batch`` (the model's inputs and 'gt'): the
        recipe's augmentation (:meth:`augment`), forward in train mode with
        the scheduled BN momentum, the model's own loss at the float epoch
        ``epoch_f``, backward, these three on cuDNN's deterministic
        algorithms (:func:`deterministic_cudnn`). The gradients add up over ``step_per_update``
        (k) steps, as the reference's k backward passes do; the k-th step
        clips their sum and takes one optimizer update at the scheduled lr
        of that update. Returns device scalars (no synchronisation):
        sparse_loss, dense_loss, total_loss, the float lr of the current
        update and, on a step that updates, grad_norm (the clip's norm,
        before the clip, over the parameters with a gradient: a frozen
        GDANet's flow-through gradients stay out).

        ``noise`` fixes the model's draws: the denoise jitter's standard
        normal (AdaPoinTr) or the point sampling's uniform scores (GRNet).
        Else they come from ``self.generator``, after the augmentation's
        (the crop's (B, 1, 3) normal centre, then its (B, 1) crop sizes; or
        the dropping's one kept count); ``aug`` fixes the augmentation's.

        On several ranks ``batch`` is this data rank's shard; ``noise`` and
        ``aug`` may be given at the global batch's size, and each rank takes
        its rows. The gradients are all-reduced before the clip
        (:func:`~..parallel.mesh.reduce_gradients`) and the returned losses
        are the global batch's means, the same on every rank."""
        with trace.span("runner.train_step", unit=self.step):
            mesh = self.mesh
            B = len(next(iter(batch.values())))
            noise = self._local_rows(noise, B)
            aug = {k: self._local_rows(v, B) if torch.is_tensor(v) and v.dim() else v
                   for k, v in (aug or {}).items()}
            with data_parallel(mesh.data):
                batch = self._to_device(batch)
                with trace.span("runner.augment"):
                    batch = self.augment(batch, epoch_f, aug)
                self.model.train()
                k = self.step_per_update
                lr = self.lr_sched(self.step // k)
                if self.step % k == 0:
                    self.optimizer.zero_grad(set_to_none=True)
                with deterministic_cudnn():  # bit-equal gradients from one state
                    with trace.span("runner.forward"):
                        ret = self.model(*self._inputs(batch), bn_momentum=self.bnm_sched(epoch_f),
                                         generator=self.generator, noise=noise)
                    with trace.span("runner.loss"):
                        with points_axis_sharding(mesh.points) if mesh.sp > 1 else contextlib.nullcontext():
                            sparse, dense = self.model.loss(ret, batch["gt"], epoch_f)
                        total = sparse + dense
                    with trace.span("runner.backward"):
                        total.backward()
            for name, p in self.model.named_parameters():
                if p.grad is not None and any(m in name for m in ZERO_GRAD_PARAM_MARKERS):
                    raise RuntimeError(f"{name} got a gradient: it must stay out of the graph")
            self.step += 1
            losses = reduce_mean(torch.stack([sparse.detach(), dense.detach(), total.detach()]), mesh.data)
            out = {"sparse_loss": losses[0], "dense_loss": losses[1], "total_loss": losses[2], "lr": lr}
            if self.step % k == 0:
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                with trace.span("runner.clip"):
                    trainable = [p for p in self.model.parameters() if p.requires_grad]
                    reduce_gradients(trainable, mesh, self.tp)
                    # torch's rule is the reference's: coef = min(max_norm / (norm + 1e-6), 1)
                    out["grad_norm"] = clip_grad_norm(trainable, self.grad_clip, mesh, self.tp)
                with trace.span("runner.optimizer"):
                    self.optimizer.step()
            return out

    # -------------------------------------------------------------- eval steps
    @torch.inference_mode()
    def predict(self, batch: dict):
        """(coarse, dense) clouds of the model in eval mode for a batch on the device."""
        with trace.span("runner.predict", unit=self.predicts):
            self.predicts += 1
            self.model.eval()
            return self.model(*self._inputs(batch))

    @torch.inference_mode()
    def _eval_core(self, batch: dict):
        """(B, 5) per-sample metrics in EVAL_KEYS order and the (coarse,
        dense) clouds: one nearest-neighbour pass per cloud pair."""
        coarse, dense = self.predict(batch)
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
        """(B, 9) per-sample rows: EVAL_KEYS, then the reference's Metrics
        row (``compute_metrics_per_sample``). Each row is one batch-1 test
        evaluation: its CDs drop that sample's zero-padded rows (the
        reference's ``ignore_zeros``), which takes the masked
        nearest-neighbour path; its F-Score is always recomputed by the
        exact pass (the eval suite may have selected by the opt-in
        matmul-form kernel, whose band could move hits across the
        threshold; the JAX runner recomputes it only then); its EMD x1000
        is the auction's (eps 0.005, 100 iterations), 0 unless
        ``require_emd``."""
        batch = self._to_device(batch)
        rows, (_, dense) = self._eval_core(batch)
        protocol = compute_metrics_per_sample(dense, batch["gt"], require_emd=require_emd,
                                              ignore_zeros=True)
        return torch.cat([rows, protocol.to(rows.dtype)], dim=1).double().cpu().numpy()

    @torch.inference_mode()
    def crop_eval_rows(self, gt: torch.Tensor, num_crop: int) -> np.ndarray:
        """(8, B, 5) EVAL_KEYS rows of the ShapeNet-55 protocol for gt
        (B, N, 3) on the device: each cloud cropped towards each of the 8
        viewpoints (its ``num_crop`` nearest points dropped), FPS'd to 2048,
        completed and scored against the whole gt; all crops of the batch
        in one forward, viewpoint-major. Under the matmul-form eval flag the
        F-Score is recomputed by the exact pass."""
        B, N, _ = gt.shape
        V = len(SHAPENET55_VIEWPOINTS)
        gt_rep = gt.unsqueeze(0).expand(V, B, N, 3).reshape(V * B, N, 3)
        views = torch.tensor(SHAPENET55_VIEWPOINTS, dtype=gt.dtype, device=gt.device).repeat_interleave(B, 0)
        partial, _ = separate_point_cloud(gt_rep, num_crop, fixed_point=views)
        rows, (_, dense) = self._eval_core({"partial": fps(partial, CROP_INPUT_POINTS), "gt": gt_rep})
        if mxu_eval_chamfer_active(dense.shape[1], N, dense.device):
            rows[:, 4] = f_score(dense, gt_rep, reduce=False).to(rows.dtype)
        return rows.reshape(V, B, -1).double().cpu().numpy()

    # ------------------------------------------------------------- checkpoints
    def pending_grads(self) -> dict | None:
        """The gradient sum of the batches since the last update (by
        parameter name), None right after an update. On several ranks it is
        the sum the update would see, reduced over the ranks (whole
        tensors under ``--tp``); every rank must call it."""
        if self.step % self.step_per_update == 0:
            return None
        named = [(n, p) for n, p in self.model.named_parameters() if p.grad is not None]
        grads = {n: p.grad.detach().clone() for n, p in named}
        reduce_tensors([(grads[n], self.tp.is_sliced(p)) for n, p in named], self.mesh)
        return {n: self.tp._full(self.tp.sliced[n], g) if n in self.tp.sliced else g for n, g in grads.items()}

    def _set_pending_grads(self, grads: dict) -> None:
        """A checkpoint's pending sum (whole tensors) as this rank's share."""
        for name, p in self.model.named_parameters():
            g = grads.get(name)
            p.grad = None if g is None else self.tp.local_share(name, g.to(p.device, p.dtype))

    def save(self, prefix: str, epoch: int, metrics, best_metrics) -> str | None:
        """Write ``<prefix>.pth`` from rank 0 (every rank must call it: the
        whole tensors of ``--tp`` and the pending sum are gathered first)."""
        pending = self.pending_grads()
        with self.tp.unsharded(self.optimizer):
            if not self.mesh.is_main:
                return None
            return save_checkpoint(
                self.model, self.optimizer, epoch, self.step,
                metrics.state_dict() if metrics else None,
                best_metrics.state_dict() if best_metrics else None,
                prefix, self.args.experiment_path, self.logger, generator=self.generator,
                pending_grads=pending,
            )

    def load_weights(self, path: str) -> None:
        """Weights only, from a checkpoint of this runner, a reference-layout
        ``.pth`` or a JAX ``.ckpt`` (a path, a bare prefix, or either inside
        the experiment directory); optimizer and schedules stay fresh."""
        with self.tp.unsharded():
            load_weights(self.model, path, self.config.model, getattr(self.args, "experiment_path", None))

    def resume(self, path: str) -> dict:
        """Continue from the checkpoint at ``path``: this runner's ``.pth``
        (weights, optimizer, step, the pending ``step_per_update`` sum and
        the train draws' generator), or a JAX ``.ckpt`` (weights, BN
        statistics, optimizer state, step, and the pending sum its
        ``MultiSteps`` state holds; the JAX run's random stream is not the
        port's, so the generator stays as seeded). Returns the checkpoint's ``epoch`` and ``best_metrics``."""
        self.model.zero_grad(set_to_none=True)
        with self.tp.unsharded(self.optimizer):
            if path.endswith(".pth"):
                meta = load_checkpoint(path, self.model, self.optimizer, self.generator)
                pending = {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None}
                self.step = int(meta["step"])
            else:
                tree, jax_meta = load_jax_checkpoint(path)
                load_flax_weights(self.model, tree, self.config.model)
                opt_state = tree.get("opt_state")
                pending = {}
                if opt_state is not None:
                    self.optimizer.load_state_dict(
                        optimizer_state_from_optax(opt_state, self.config.model, self.model, self.optimizer))
                    pending = pending_grads_from_optax(opt_state, self.config.model, self.model)
                self.step = int(tree.get("step", 0))
                meta = {"epoch": jax_meta.get("epoch", -1), "best_metrics": jax_meta.get("best_metrics")}
            self.model.zero_grad(set_to_none=True)
        self._set_pending_grads(pending)
        return meta


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
def resume_path(experiment_path: str) -> str | None:
    """The checkpoint ``--resume`` continues from: the port's
    ``ckpt-last.pth``, else the JAX run's ``ckpt-last.ckpt``, else None."""
    for path in (checkpoint_path("ckpt-last", experiment_path),
                 os.path.join(experiment_path, "ckpt-last.ckpt")):
        if os.path.exists(path):
            return path
    return None


def maybe_wandb(args, config):
    """``--wandb``: one wandb run for the training, or None; without the
    ``wandb`` package it says so and goes on (``_maybe_wandb`` of
    ``imgadapointr_tpu/tools/runner.py:626-640``)."""
    if not getattr(args, "wandb", False):
        return None
    try:
        import wandb
    except ImportError:
        print_log("wandb requested but not installed; skipping", getattr(args, "logger", None))
        return None
    return wandb.init(project="imgadapointr_tpu", name=getattr(args, "exp_name", "run"), config=dict(config))


def _profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _stop_profile(prof, path: str, logger) -> None:
    """Stop ``--profile``'s profiler, write its chrome trace and log the
    port's spans recorded meanwhile (:mod:`..utils.trace`), by name."""
    prof.stop()
    os.makedirs(path, exist_ok=True)
    chrome = os.path.join(path, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(chrome)
    print_log(f"profiler trace written to {chrome}", logger)
    print_log(f"spans of the profiled steps:\n{trace.table()}", logger)


def loader_line(at_start: dict) -> str:
    """The loaders' counters (``datasets/loader.py``) since the reading
    ``at_start``: batches handed out, the consumer's seconds waiting for
    them, and the seconds spent decoding samples, on the wall clock and on
    the decoding threads' CPU clocks (wall well above CPU: the decode
    threads wait for the interpreter lock). Worker processes decode in
    their own processes, outside these counters."""
    now = trace.counters()
    d = {k: now.get(k, 0) - at_start.get(k, 0) for k in LOADER_COUNTERS}
    return (f"Loader = {d['loader.batches']:.0f} batches, wait {d['loader.wait_s']:.3f}s, "
            f"decode {d['loader.decode_s']:.3f}s wall / {d['loader.decode_cpu_s']:.3f}s CPU")


def run_net(args, config, writers=None) -> Runner:
    """Train ``config`` with validation and checkpoints. ``writers`` is the
    (train, validation) pair of TensorBoard writers (either may be None)."""
    logger = getattr(args, "logger", None)
    train_writer, val_writer = writers or (None, None)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, val_loader = dataset_builder(args, config.dataset.val)
    runner = Runner(args, config, logger)
    steps_per_epoch = max(len(train_loader), 1)
    runner.make_train_state(steps_per_epoch)

    start_epoch, best_metrics = 0, None
    last = resume_path(args.experiment_path) if getattr(args, "resume", False) else None
    if last:
        meta = runner.resume(last)
        start_epoch = int(meta["epoch"]) + 1
        if meta["best_metrics"]:
            best_metrics = Metrics(runner.consider_metric, meta["best_metrics"])
        print_log(f"Resumed from epoch {start_epoch} ({os.path.basename(last)})", logger)
    elif getattr(args, "start_ckpts", None):
        runner.load_weights(args.start_ckpts)
        print_log(f"Warm-start weights loaded from {args.start_ckpts} "
                  "(fresh optimizer/schedules)", logger)

    max_epoch = int(config.max_epoch)
    save_freq = max(1, int(getattr(args, "save_freq", 1) or 1))
    wandb_run = maybe_wandb(args, config) if runner.mesh.is_main else None
    profiling = None  # the live torch.profiler of --profile
    try:
        for epoch in range(start_epoch, max_epoch):
            # the epoch's order and samples depend on (seed, epoch) only, so a
            # resumed run sees the batches an uninterrupted one would
            train_loader.set_epoch(epoch)
            losses = AverageMeter(["SparseLoss", "DenseLoss"])
            step_losses = []  # device scalars, fetched once at the epoch's end
            epoch_start = t0 = time.time()
            loader_at_start = trace.counters()
            n_batches = len(train_loader)
            for idx, (_, _, batch) in enumerate(train_loader):
                if getattr(args, "profile", False) and epoch == start_epoch:
                    if idx == PROFILE_WINDOW[0]:
                        trace.reset()
                        profiling = _profiler(runner.device)
                        profiling.start()
                    elif idx == PROFILE_WINDOW[1] and profiling is not None:
                        _stop_profile(profiling, args.tfboard_path, logger)
                        profiling = None
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
                    if train_writer:
                        step = epoch * steps_per_epoch + idx
                        train_writer.add_scalar("Loss/Batch/Sparse", sparse, step)
                        train_writer.add_scalar("Loss/Batch/Dense", dense, step)
                        train_writer.add_scalar("LR/Batch", m["lr"], step)
                t0 = time.time()
            if profiling is not None:  # an epoch shorter than the window
                _stop_profile(profiling, args.tfboard_path, logger)
                profiling = None
            if step_losses:
                ep = (torch.stack(step_losses).mean(dim=0) * 1000).tolist()
            else:
                ep = losses.avg()
            print_log(
                f"[Training] EPOCH: {epoch} EpochTime = {time.time() - epoch_start:.3f}s "
                f"Losses = {['%.4f' % v for v in ep]} {loader_line(loader_at_start)}", logger,
            )
            if train_writer:
                train_writer.add_scalar("Loss/Epoch/Sparse", ep[0], epoch)
                train_writer.add_scalar("Loss/Epoch/Dense", ep[1], epoch)
            if wandb_run:
                wandb_run.log({"epoch": epoch, "train/sparse": ep[0], "train/dense": ep[1]})

            # --save_freq: ckpt-last on every save_freq-th epoch and on the
            # last two (imgadapointr_tpu/tools/runner.py:536-555); ckpt-best
            # on every improvement, as the reference writes it (the JAX
            # runner writes it on saving epochs only, so a best on another
            # epoch was lost)
            save_epoch = epoch % save_freq == 0 or epoch >= max_epoch - 2
            if epoch % int(getattr(args, "val_freq", 1)) == 0:
                metrics = validate(runner, val_loader, epoch, logger, val_writer)
                if wandb_run:
                    wandb_run.log({"epoch": epoch, **{f"val/{k}": v for k, v in metrics.state_dict().items()}})
                if metrics.better_than(best_metrics):
                    best_metrics = metrics
                    runner.save("ckpt-best", epoch, metrics, best_metrics)
            if save_epoch:
                runner.save("ckpt-last", epoch, None, best_metrics)
            if epoch > max_epoch - 2:
                runner.save(f"ckpt-epoch-{epoch:03d}", epoch, None, best_metrics)
            rss_watchdog(runner, epoch, max_epoch, save_epoch, best_metrics, logger)
    finally:  # the loaders' workers and a trace left open by an exception
        if profiling is not None:
            profiling.stop()
        train_loader.close()
        val_loader.close()
    return runner


def rss_watchdog(runner: Runner, epoch: int, max_epoch: int, save_epoch: bool, best_metrics,
                 logger=None) -> None:
    """The RSS watchdog at an epoch's end, a clean point to stop: above
    :func:`rss_limit_gb`, save ``ckpt-last`` (unless this epoch saved it)
    and exit ``RSS_RESTART_EXIT_CODE`` for a ``--resume`` relaunch. The
    reading is the current RSS (:func:`host_rss_gb`), and on several ranks
    the decision is the maximum over them (an all-reduce), so every rank
    saves and exits together rather than leave the others blocked in a
    collective. Not after the last epoch."""
    rss_limit = rss_limit_gb()
    if not rss_limit or epoch >= max_epoch - 1:
        return
    rss = reduce_max(host_rss_gb(), runner.mesh)
    if rss <= rss_limit:
        return
    if not save_epoch:  # so that the resumed run loses nothing
        runner.save("ckpt-last", epoch, None, best_metrics)
    print_log(f"[rss-watchdog] host RSS {rss:.1f} GB > limit {rss_limit:.1f} GB "
              f"after epoch {epoch}; ckpt-last saved: exiting {RSS_RESTART_EXIT_CODE} "
              "for a --resume relaunch", logger)
    sys.exit(RSS_RESTART_EXIT_CODE)


# ------------------------------------------------------------------- validate
def _accumulate(category_metrics: dict, taxonomy_ids, rows) -> None:
    for tax, row in zip(taxonomy_ids, rows):
        category_metrics.setdefault(tax, AverageMeter(METRIC_NAMES)).update([float(v) for v in row])


def _overall(category_metrics: dict) -> np.ndarray:
    """Mean of the per-category means (reference tools/runner.py:410-411)."""
    if not category_metrics:
        return np.zeros(len(METRIC_NAMES))
    return np.array([am.avg() for am in category_metrics.values()]).mean(axis=0)


def validate(runner: Runner, val_loader, epoch: int, logger=None, val_writer=None) -> Metrics:
    """The validation metrics (mean of the per-category means); with a
    writer, also the per-sample means of the sparse and dense CD-L1
    (``Loss/Epoch/*``) and the metrics (``Metric/*``), as JAX's
    ``validate`` writes them."""
    print_log(f"[VALIDATION] Start validating epoch {epoch}", logger)
    category_metrics: dict[str, AverageMeter] = {}
    cd_l1 = []  # (sparse, dense) CD-L1 of each sample
    for taxonomy_ids, _, batch in val_loader:
        rows = runner.eval_step(batch)
        cd_l1.append(rows[:, [0, 2]])
        # [F-Score, CDL1, CDL2, EMD] of the dense cloud; EMD is not validated
        _accumulate(category_metrics, taxonomy_ids,
                    np.concatenate([rows[:, [4, 2, 3]], np.zeros((len(rows), 1))], axis=1))
    overall = _overall(category_metrics)
    print_log("[Validation] EPOCH: %d Metrics = %s" % (epoch, ["%.4f" % v for v in overall]), logger)
    for tax, am in sorted(category_metrics.items()):
        print_log(f"  {tax}: {['%.4f' % v for v in am.avg()]}", logger)
    if val_writer:
        sparse, dense = np.concatenate(cd_l1).mean(axis=0) if cd_l1 else (0.0, 0.0)
        val_writer.add_scalar("Loss/Epoch/Sparse", float(sparse), epoch)
        val_writer.add_scalar("Loss/Epoch/Dense", float(dense), epoch)
        for name, v in zip(METRIC_NAMES, overall):
            val_writer.add_scalar(f"Metric/{name}", float(v), epoch)
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
    try:
        return test(runner, test_loader, args, config, logger)
    finally:
        test_loader.close()


def _load_shapenet_dict() -> dict:
    """Taxonomy id -> name; like the configs' ``_base_`` includes, the path
    is relative to the working directory, and a missing file raises."""
    with open(SHAPENET_DICT_PATH) as f:
        return json.load(f)


def test(runner: Runner, test_loader, args, config, logger=None) -> dict:
    """The test protocol of the test split's reader: ShapeNet-55's
    (:func:`_test_shapenet55`), KITTI's (:func:`_test_kitti`), else PCN's:
    per-taxonomy and overall F-Score, CD-L1, CD-L2 and EMD (x1000); EMD
    reads 0 with ``--no_emd``."""
    name = config.dataset.test.get("NAME", "")
    if "ShapeNet" in name and "PCN" not in name:
        return _test_shapenet55(runner, test_loader, args, config, logger)
    if name == "KITTI":
        return _test_kitti(runner, test_loader, args, config, logger)
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


def _test_shapenet55(runner: Runner, test_loader, args, config, logger=None) -> dict:
    """The ShapeNet-55/34 protocol (``imgadapointr_tpu/tools/runner.py:834-906``):
    each gt cloud cropped towards 8 fixed viewpoints at the ``--mode``'s
    ratio (``median`` by default), completed and scored against the whole
    cloud (:meth:`Runner.crop_eval_rows`); per-taxonomy means of the 8
    rows of each cloud, and their mean; EMD is not taken (0)."""
    npoints = int(config.dataset.test.get("N_POINTS", 8192))
    mode = getattr(args, "mode", None) or "median"
    num_crop = int(npoints * CROP_RATIO[mode])
    category_metrics: dict[str, AverageMeter] = {}
    for taxonomy_ids, _, batch in test_loader:
        rows = runner.crop_eval_rows(batch["gt"][:, :npoints].to(runner.device), num_crop)
        for b, tax in enumerate(taxonomy_ids):
            _accumulate(category_metrics, [tax] * len(rows),
                        np.concatenate([rows[:, b][:, [4, 2, 3]], np.zeros((len(rows), 1))], axis=1))
    overall = _overall(category_metrics)
    print_log(f"[ShapeNet-55 {mode}] Overall: "
              + " ".join(f"{n}={v:.4f}" for n, v in zip(METRIC_NAMES, overall)), logger)
    return dict(zip(METRIC_NAMES, overall))


def _test_kitti(runner: Runner, test_loader, args, config, logger=None) -> dict:
    """The KITTI protocol (``imgadapointr_tpu/tools/runner.py:909-931``): no
    ground truth, so no metric; one image a cloud of its input and its
    completion, ``<model_id>_<index>.jpg`` under ``vis_result/`` of the
    experiment, drawn as JAX's matplotlib figure by ``utils/render.py``."""
    target_path = os.path.join(args.experiment_path, "vis_result")
    os.makedirs(target_path, exist_ok=True)
    for idx, (_, model_ids, batch) in enumerate(test_loader):
        with torch.inference_mode():
            _, dense = runner.predict(runner._to_device(batch))
        partial, dense = batch["partial"][0].numpy(), dense[0].float().cpu().numpy()
        render.save_kitti(os.path.join(target_path, f"{model_ids[0]}_{idx:03d}.jpg"), partial, dense)
    print_log(f"[KITTI] visualisations saved to {target_path}", logger)
    return {}
