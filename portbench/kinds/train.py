"""The ``train`` kind: ``Runner.train_step`` at the traffic's ``batch``, fed by
the port's ``Loader`` over a PCN tree on disk (``source: disk``; a fixed data
set, as PCN is, written from the traffic's own seed by a checkout's first
run and read by every run after; the run's seed draws the epochs' order and
each sample's render, cut and mirror), or by batches gathered on the device
from a pool of synthetic samples made at set-up from the run's seed
(``source: memory``).

Set-up builds the one training object and drives its first
``checked_steps`` steps through the window's own call and feed; no step
comes before them, so they are the object's warm-up as well. The window
goes on from that state. The check compares those steps with the plain
reference from the same weights, draws and batches: the first step's
losses, the first clipped gradient (from AdamW's first moment after one
step) and each leaf's change over the checked steps.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from .. import compare
from ..reference import data as ref_data
from ..reference import models as ref_models
from ..reference import optim as ref_optim
from ..workloads import Run, free, sub_seed, sync, tf32


class Train(Run):
    """``Runner.train_step`` fed from disk or from memory."""

    def setup_data(self):
        """The run's inputs: the denoise draws, and the tree or the pool."""
        t = self.traffic
        self.k_checked = int(t["checked_steps"])
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 1))
        self.noise = [torch.randn((self.batch, ref_models.DENOISE_LENGTH, 3), generator=g, device=self.device)
                      for _ in range(int(t["noise_pool"]))]
        if t["source"] == "disk":
            self.tree, self.cats = self.pcn_tree()
            self.steps_per_epoch = sum(t["tree"]["taxonomies"].values()) // self.batch
        else:
            pool = self.samples(int(t["pool"]), sub_seed(self.seed, 3))
            self.pool = {k: v.to(self.device) for k, v in pool.items()}
            self.steps_per_epoch = int(t["pool"]) // self.batch

    def pcn_tree(self):
        """(directory, category entries) of the traffic's PCN tree under the
        checkout's cache, at a path fixed by the tree's parameters; written
        whole under another name and renamed, so a cut run leaves no half tree."""
        t = self.traffic
        spec = json.dumps({"tree": t["tree"], "dataset": t["dataset"]}, sort_keys=True)
        path = os.path.join(self.cell.cache_dir, "pcn_trees", hashlib.sha256(spec.encode()).hexdigest()[:16])
        if not os.path.isdir(path):
            part = path + ".partial"
            shutil.rmtree(part, ignore_errors=True)
            ref_data.write_pcn_tree(part, t["dataset"], t["tree"], int(t["tree"]["seed"]))
            os.replace(part, path)
        with open(ref_data.pcn_paths(path, t["dataset"])["CATEGORY_FILE_PATH"]) as f:
            return path, json.load(f)

    def setup(self):
        with self.spans("setup_data"):
            self.setup_data()
        if self.traffic["source"] == "disk":
            from imgadapointr_tpu_torch.tools.builder import dataset_builder
            from imgadapointr_tpu_torch.utils.config import AttrDict

            t = self.traffic
            ds = dict(t["dataset"], **ref_data.pcn_paths(self.tree, t["dataset"]),
                      others={"subset": "train", "bs": self.batch})
            args = argparse.Namespace(seed=self.seed, tp=1, sp=1, **t["loader"])
            _, self.loader = dataset_builder(args, AttrDict(ds))
            if len(self.loader) != self.steps_per_epoch:
                raise ValueError(f"the loader has {len(self.loader)} steps an epoch, the tree {self.steps_per_epoch}")
        with self.spans("setup_program"):
            self.runner = self.build_runner()
            self.runner.make_train_state(self.steps_per_epoch)
        self.feed = self.batches()
        # the checked steps: the object's first steps, through the window's own call and feed, on rows that all differ
        if self.runner.step or self.runner.optimizer.state:
            raise RuntimeError("a step came before the checked steps: the check covers the object's first steps")
        model = self.runner.model
        theta0 = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        self.checked_batches, self.prog_losses = [], []
        for i in range(self.k_checked):
            epoch_f, batch = next(self.feed)
            self.checked_batches.append((epoch_f, {k: v.detach().to("cpu", copy=True) for k, v in batch.items()}))
            out = self.step(i, epoch_f, batch)
            self.prog_losses.append((float(out["sparse_loss"]), float(out["dense_loss"])))
            if i == 0:  # the clipped gradient, from AdamW's first moment after one step
                opt = self.runner.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                self.prog_grad = {n: float(opt.state[p]["exp_avg"].norm() / (1 - b1))
                                  for n, p in model.named_parameters() if p in opt.state}
        self.prog_change = {n: float((p.detach().cpu() - theta0[n]).norm()) for n, p in model.named_parameters()}
        self.steps_done = self.k_checked
        sync(self.device)

    def memory_batch(self, epoch: int, idx: int) -> dict:
        order = np.random.default_rng((self.seed, epoch)).permutation(int(self.traffic["pool"]))
        rows = torch.from_numpy(order[idx * self.batch:(idx + 1) * self.batch]).to(self.device)
        return {k: v.index_select(0, rows) for k, v in self.pool.items()}

    def batches(self):
        """(float epoch, batch) for ever, as ``run_net`` feeds them."""
        epoch = 0
        while True:
            if self.traffic["source"] == "disk":
                self.loader.set_epoch(epoch)
                for idx, (_, _, batch) in enumerate(self.loader):
                    yield epoch + idx / self.steps_per_epoch, batch
            else:
                for idx in range(self.steps_per_epoch):
                    yield epoch + idx / self.steps_per_epoch, self.memory_batch(epoch, idx)
            epoch += 1

    def step(self, i: int, epoch_f: float, batch: dict):
        return self.runner.train_step(batch, epoch_f, noise=self.noise[i % len(self.noise)])

    def window(self, seconds: float) -> dict:
        spans = self.spans
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("loader_wait"):
                epoch_f, batch = next(self.feed)
            with spans("train_step"):
                self.step(self.steps_done, epoch_f, batch)
            self.steps_done += 1
            steps += 1
        with spans("synchronize"):
            sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "units": steps, "clouds": steps * self.batch, "attempted": steps, "failed": 0,
                "end_to_end": {"train_clouds_per_s": steps * self.batch / elapsed}}

    def release(self) -> None:
        self.feed.close()
        if self.traffic["source"] == "disk":
            self.loader.close()
        self.runner = self.feed = None
        free()

    def reference_batches(self) -> list:
        """The checked steps' (float epoch, batch), worked out by the reference:
        read from disk by the plain reader, or gathered from the pool."""
        out = []
        for i in range(self.k_checked):
            if self.traffic["source"] == "disk":
                b = ref_data.pcn_train_batch(self.tree, self.traffic["dataset"], self.cats, self.seed, 0, i,
                                             self.batch)
                batch = {k: torch.from_numpy(v) for k, v in b.items()}
            else:
                batch = {k: v.cpu() for k, v in self.memory_batch(0, i).items()}
            out.append((i / self.steps_per_epoch, batch))
        return out

    def reference_steps(self, batches: list, control: bool = False) -> dict:
        """The reference's steps over ``batches`` from the run's first weights
        and draws: each step's losses, the first clipped gradient's leaf norms
        and the leaves' change over the steps."""
        model = self.reference()
        model.train()
        lr_of, bnm_of = ref_optim.schedules(self.run_cfg)
        params = dict(model.named_parameters())
        opt = ref_optim.AdamW({n: p for n, p in params.items() if p.requires_grad},
                              float(self.run_cfg["optimizer"]["kwargs"].get("weight_decay", 0.0)))
        clip_norm = float(self.run_cfg.get("grad_norm_clip", 10.0))
        losses, grad1 = [], None
        theta0 = {n: p.detach().clone() for n, p in params.items()}
        for i, (epoch_f, batch) in enumerate(batches):
            batch = {k: v.to(self.device) for k, v in batch.items()}
            inputs = [batch[k] for k in self.inputs]
            with tf32(control):
                ret = model(inputs[0], *inputs[1:], bn_momentum=bnm_of(epoch_f), noise=self.noise[i % len(self.noise)])
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

    @staticmethod
    def gaps(prog: dict, ref: dict) -> dict:
        gaps = compare.loss_gaps(prog["losses"], ref["losses"])
        values = {"step1_loss_gap": gaps[0]}
        if set(ref["grad1"]) != set(prog["grad1"]):  # a leaf moved on one side only: no sound run
            values["grad_gap"] = values["change_gap"] = 1.0
            return values
        values["grad_gap"], _ = compare.norm_gap(prog["grad1"], ref["grad1"])
        values["change_gap"], _ = compare.norm_gap(prog["change"], ref["change"], compare.live_leaves(ref["grad1"]))
        return values

    def check(self) -> dict:
        batches = self.reference_batches()
        prog = {"losses": self.prog_losses, "grad1": self.prog_grad, "change": self.prog_change}
        ref = self.reference_steps(batches)
        values = self.gaps(prog, ref)
        self.detail = {"loss_gaps": compare.loss_gaps(prog["losses"], ref["losses"])}
        if self.traffic["source"] == "disk":
            values["batch_mismatch"] = float(sum(int((b[k] != p[k]).sum()) for (_, b), (_, p)
                                                 in zip(batches, self.checked_batches) for k in b))
        return values

    def control(self) -> dict:
        """The reference in TF32 in the program's place: its numbers."""
        self.setup_data()
        batches = self.reference_batches()
        ctl, ref = self.reference_steps(batches, control=True), self.reference_steps(batches)
        self.detail = {"loss_gaps": compare.loss_gaps(ctl["losses"], ref["losses"])}
        return self.gaps(ctl, ref)


KIND = Train
