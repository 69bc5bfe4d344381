#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero and prints no result line:

1. checks: a CUDA device, the card's name and power limit (nvidia-smi), and
   the build of every kernel in ``imgadapointr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch version on the card, at each
   shape one serving request (batch ``B``), one train step (batch
   ``B_TRAIN``) and one request of the segmentation models (batch ``B``)
   give it (the one-direction argmin: one test cloud), plus edge probes
   (identical clouds, dense sphere, all-equal points, out-of-range
   indices, masks).
   Indices must be equal and values bit-equal (tolerance 0): each kernel
   repeats its plain version's arithmetic. The scatter-add sums with
   float32 atomics in no fixed order, so it is held to 1e-5 of each
   element's sum of absolute contributions, and to bit-equality where
   every row receives one contribution; the weighted gather-sum sums in
   another order than its plain version and is held to 1e-5 of each
   element's sum of absolute terms. Each kernel, its plain version
   and, where one PyTorch call computes the same function, that call are
   timed with CUDA events over one serving request's calls (the
   scatter-add: one train step's; the one-direction argmin: one test
   cloud's; the weighted gather-sum: one superset request's);
3. the serving path at full width: ``cfgs/PCN_models/AdaPoinTr.yaml`` with
   seeded weights answers ``REQUESTS`` requests of ``B`` synthetic PCN
   partial clouds (2048 points) with coarse (512) and fine (16384)
   clouds, scored by CD-L1, CD-L2 and F-Score against the 16384-point
   ground truth. The launch counts of that run must equal the calls the
   request table predicts, and one request is held against the same
   model run on the CPU through the plain versions;
4. the training path at full width: the ``Runner`` on the same config at
   batch 16 (2048 -> 512 + 16384, 64 denoise queries) takes 1 warm-up and
   ``TRAIN_STEPS`` timed steps on ``SyntheticPCN``, then validates on 2
   clouds and runs the test protocol on 2 clouds at batch size 1 (the
   masked chamfer path). Losses and gradient norms must be finite, the
   query-ranking parameters untouched and every other one changed, the
   launches of the train steps, of validate and of test equal to the
   tables derived from the config, a checkpoint must
   read back bit-equal, and one step at batch 2 must agree with the same
   step on the CPU through the plain versions (loss 1e-4, gradient norm
   1e-3, relative);
5. the image and segmentation serving path at full width:
   ``ImgEncSegDecAdaPoinTrVariableLoss`` (the superset: ResNet18 image
   fusion after the encoder, frozen GDANet on the 512 ranked queries) with
   seeded weights answers ``REQUESTS`` requests of ``B`` synthetic
   (partial cloud, 224x224 image, class one-hot) triples with coarse and
   fine clouds and their metrics; launches must equal the request table
   (the flagship's plus GDANet's kNN, gathers and two weighted
   gather-sums), one request is profiled, and one request at batch 2 is
   held against the CPU (clouds as sets, the last ranking layer scaled as
   in phase 4; GDANet's selections that differ are counted). Then one
   request each of ``SegEncAdaPoinTr`` (GDANet on the encoder centres) and
   ``ImgResNetEncAdaPoinTrVariableLoss`` (image only), with their tables;
6. the superset's training at full width: the ``Runner`` on
   ``ImgEncSegDecAdaPoinTrVariableLoss`` at batch 16 (2048 -> 512 + 16384,
   224x224 images, class one-hots) takes 1 warm-up and ``TRAIN_STEPS``
   timed steps, with the launch table (the flagship's step plus GDANet's
   pass, its gathers' backward scatters, and two each of the weighted
   gather-sum and its two backward kernels), GDANet frozen and every other
   trainable parameter moved, one profiled step and the peak memory; then
   one step at batch 2 against the CPU (losses 1e-4 relative, gradient
   norm ``SUPERSET_GRAD_NORM_TOL``, GDANet's differing selections counted).

Phase 2 also holds the gather-sum's two backward kernels (at the superset
train step's GDANet shapes and the tiny config's, 1e-5 of each element's
absolute sum) and the auction top-2 (16384 x 16384, every row live and a
small count, values bit-equal and indices equal) against their plain
versions. Phase 4's test protocol runs the auction EMD at 16384 x 16384 on
each cloud: its time per cloud, iterations, top-2 launches, and one cloud's
assignment through the kernel equal to the plain path's.

Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.datasets import SyntheticPCN
from imgadapointr_tpu_torch.main import swap_synthetic
from imgadapointr_tpu_torch.models import build_model
from imgadapointr_tpu_torch.models import gdanet as port_gdanet
from imgadapointr_tpu_torch.ops import _build
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.tools.builder import dataset_builder
from imgadapointr_tpu_torch.utils.checkpoint import load_checkpoint
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.metrics import eval_metric_suite

CONFIG = "cfgs/PCN_models/AdaPoinTr.yaml"
SUPERSET = "cfgs/SegImgPCN_models/ImgEncSegDecAdaPoinTrVariableLoss.yaml"
BRANCH_CONFIGS = ("cfgs/SegImgPCN_models/SegEncAdaPoinTr.yaml",
                  "cfgs/ImgPCN_models/ImgResNetEncAdaPoinTrVariableLoss.yaml")
N_PARTIAL = 2048
B = 8  # clouds per request
REQUESTS = 3
B_TRAIN = 16  # the config's total_bs
TRAIN_STEPS = 5
DENOISE = 64  # denoise queries of a train step
EVAL_CLOUDS = 2  # clouds validated, and clouds tested, at batch size 1
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# float32 outside the tensor cores (the kernels do no matrix products).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per candidate pair: 3 subtracts, 3 multiplies, 2 adds, and
# one compare per direction the pair is ranked in
OPS_PAIR_ONE_WAY = 9
OPS_PAIR_BIDIR = 10
# the auction's bid value per pair: 3 subtracts, 3 multiplies, 2 adds, the
# price's subtract, and a compare
OPS_PAIR_TOP2 = 10
EMD_EPS, EMD_ITERATIONS = 0.005, 100  # the test protocol's auction
# Card against CPU, one superset step at batch 2: GDANet ranks its feature
# neighbours by the float32 matmul form on both devices, and at near-ties the
# two pick different neighbours (151 of 227,328 selections in the serving
# check); each such pick changes a point's edge feature, its max-pool and the
# gradient that flows back through it, so the gradient norm is held to 10x
# the flagship's 1e-3; the losses keep the flagship's 1e-4.
SUPERSET_GRAD_NORM_TOL = 1e-2

SOURCES = {
    "nn_bidir_argmin": ("imgadapointr_tpu_torch/csrc/nn_bidir_argmin.cu",
                        "imgadapointr_tpu/ops/pallas/nn_distance.py:194"),
    "knn": ("imgadapointr_tpu_torch/csrc/knn.cu",
            "imgadapointr_tpu/ops/pallas/nn_distance.py:498"),
    "fps": ("imgadapointr_tpu_torch/csrc/fps.cu",
            "imgadapointr_tpu/ops/pallas/fps.py:71"),
    "gather_rows": ("imgadapointr_tpu_torch/csrc/gather_rows.cu",
                    "imgadapointr_tpu/ops/pallas/gather_rows.py:179"),
    "scatter_add_rows": ("imgadapointr_tpu_torch/csrc/scatter_add_rows.cu",
                         "imgadapointr_tpu/ops/pallas/scatter_rows.py:109"),
    "nn_one_direction": ("imgadapointr_tpu_torch/csrc/nn_one_direction.cu",
                         "imgadapointr_tpu/ops/pallas/nn_distance.py:93"),
    "weighted_gather_sum": ("imgadapointr_tpu_torch/csrc/weighted_gather_sum.cu",
                            "imgadapointr_tpu/ops/pallas/gather_sum.py:113"),
    "weighted_gather_sum_dfeats": ("imgadapointr_tpu_torch/csrc/weighted_gather_sum_bwd.cu",
                                   "imgadapointr_tpu/ops/pallas/gather_sum.py:135"),
    "weighted_gather_sum_dweights": ("imgadapointr_tpu_torch/csrc/weighted_gather_sum_bwd.cu",
                                     "imgadapointr_tpu/ops/pallas/gather_sum.py:149"),
    "auction_top2": ("imgadapointr_tpu_torch/csrc/auction_top2.cu",
                     "imgadapointr_tpu/ops/pallas/auction.py:161"),
}
# Kernels that no driven path launches, and why; phase 2 holds them against
# their plain versions all the same
NOT_ON_A_PATH = {
    name: "the weighted gather-sum's VJP: the GDM's neighbour sum feeds only a top-k ranking, so no "
          "train step's cotangent reaches it (the JAX package's gradient never calls its Pallas VJP either)"
    for name in ("weighted_gather_sum_dfeats", "weighted_gather_sum_dweights")
}
PORTED_KERNEL_NAMES = ("nn_bidir", "knn_kernel", "fps_kernel", "gather_rows",
                       "scatter_add_rows", "nn_one_direction", "weighted_gather_sum",
                       "dfeats_kernel", "dweights_kernel", "auction_top2")


def log(*a):
    print(*a, flush=True)


def gdanet_calls(n: int) -> dict:
    """Each kernel's calls in one frozen-GDANet pass over n points, its
    normals included (models/seg_adapointr.py:seg_features): knn (k, S, M),
    gather_rows (M, C, S), weighted_gather_sum (S, K, M, C)."""
    k, m, k_gdm = min(30, n), min(512, n), min(64, n)
    gather = [(n, 3, n * k)] * 3  # the normals' neighbours; block 1's points and normals
    gather += [(n, 64, m)] * 2 + [(n, 64, n * k)]  # block 1's GDM; block 2's edge conv
    gather += [(n, 64, m)] * 2 + [(n, 128, n * k)]  # block 2's GDM; block 3's edge conv
    return {"knn": [(k, n, n)], "gather_rows": gather,
            "weighted_gather_sum": [(n, k_gdm - 1, n, 64)] * 2}


def request_calls(cfg) -> dict:
    """Each kernel's calls in one eval request plus its metrics, per batch
    element count, from the model config: knn (k, S, M), fps (N, npoint),
    gather_rows (M, C, S), nn_bidir_argmin (N, M), weighted_gather_sum
    (S, K, M, C). A segmentation model adds one GDANet pass: on the ranked
    queries (the superset) or on the encoder centres (SegEncAdaPoinTr)."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd, kg = int(enc.embed_dim), int(enc.k), int(dec.k), 16
    n_cand = nq + nq // 2  # coarse_pred queries + FPS seeds, before ranking
    N = N_PARTIAL
    knn = [(kg, N, N), (kg, n1, N), (kg, n1, n1), (kg, n2, n1),  # grouper
           (ke, n2, n2),  # encoder, shared by the stack
           (kd, nq, nq), (kd, nq, n2)]  # decoder self and cross
    fps = [(N, n1), (n1, n2), (N, nq // 2)]
    gather = [
        (N, 8, N * kg), (N, 3, n1), (N, 32, n1), (N, 32, n1 * kg),  # grouper 1-2
        (n1, 64, n1 * kg), (n1, 3, n2), (n1, 64, n2), (n1, 64, n2 * kg),  # 3-4
        (N, 3, nq // 2), (n_cand, 3, nq),  # query seeds, ranking
    ]
    gather += [(n2, C, n2 * ke)] * sum("graph" in s for s in enc.block_style_list)
    gather += [(nq, C, nq * kd)] * sum("graph" in s for s in dec.self_attn_block_style_list)
    gather += [(n2, C, nq * kd)] * sum("graph" in s for s in dec.cross_attn_block_style_list)
    gather += [(n_fine, 3, n_fine)] * 2  # metric residuals, both directions
    calls = {"knn": knn, "fps": fps, "gather_rows": gather,
             "nn_bidir_argmin": [(n_fine, n_fine)], "weighted_gather_sum": []}
    n_seg = {"ImgEncSegDecAdaPoinTrVariableLoss": nq, "SegEncAdaPoinTr": n2}.get(cfg.NAME)
    if n_seg:
        for name, c in gdanet_calls(n_seg).items():
            calls[name] = calls[name] + c
    return calls


def train_step_calls(cfg) -> dict:
    """Each kernel's calls in one train step (forward in train mode, the
    three chamfer losses, backward), per batch element count, from the
    model config. scatter_add_rows (rows, C, S): the chamfer cross term of
    each predicted cloud (the ground truth needs no gradient, so its cross
    term is not computed) and the backward of every gather whose table
    needs a gradient."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd, kg = int(enc.embed_dim), int(enc.k), int(dec.k), 16
    n_cand, L, Q = nq + nq // 2, DENOISE, nq + DENOISE
    factor = n_fine // nq
    N = N_PARTIAL
    n_enc = sum("graph" in s for s in enc.block_style_list)
    n_self = sum("graph" in s for s in dec.self_attn_block_style_list)
    n_cross = sum("graph" in s for s in dec.cross_attn_block_style_list)
    knn = [(kg, N, N), (kg, n1, N), (kg, n1, n1), (kg, n2, n1), (ke, n2, n2), (kd, Q, n2)]
    knn += [(kd, nq, nq), (kd, L, Q)] * n_self  # two-phase search, per graph block
    knn += [(factor, L, n_fine)]  # denoise targets
    fps = [(N, n1), (n1, n2), (N, nq // 2), (N, L)]
    # gathers whose table needs a gradient: their backward is one scatter each
    grad_gathers = [(N, 32, n1), (N, 32, n1 * kg), (n1, 64, n1 * kg), (n1, 64, n2),
                    (n1, 64, n2 * kg), (n_cand, 3, nq)]
    grad_gathers += [(n2, C, n2 * ke)] * n_enc
    grad_gathers += [(nq, C, nq * kd), (Q, C, L * kd)] * n_self
    grad_gathers += [(n2, C, Q * kd)] * n_cross
    chamfer = [(L * factor, L * factor), (nq, n_fine), (n_fine, n_fine)]  # (pred, target)
    gather = [(N, 3, N * kg), (N, 3, n1), (n1, 3, n2),  # grouper coordinates
              (N, 3, nq // 2), (N, 3, L), (n_fine, 3, L * factor)]  # seeds, denoise targets
    gather += grad_gathers
    for n_pred, n_gt in chamfer:  # residuals of both directions
        gather += [(n_gt, 3, n_pred), (n_pred, 3, n_gt)]
    scatter = [(n_pred, 3, n_gt) for n_pred, n_gt in chamfer] + grad_gathers
    return {"knn": knn, "fps": fps, "gather_rows": gather, "nn_bidir_argmin": chamfer,
            "scatter_add_rows": scatter, "nn_one_direction": [], "weighted_gather_sum": []}


def superset_train_calls(cfg) -> dict:
    """Each kernel's calls in one train step of the superset: the
    flagship's step (``train_step_calls``), plus GDANet's pass on the ranked
    queries, whose every gather has a table that needs a gradient (the
    gradient flows through the frozen net into the points), so each adds
    one scatter; and the weighted gather-sum's two forward calls. Its
    backward kernels run no time: the GDM's neighbour sum feeds only a
    top-k ranking, so no cotangent reaches it (nor in the JAX package, whose
    gradient never calls the Pallas VJP there:
    ``tests/test_torch_branch_train.py``)."""
    calls = train_step_calls(cfg)
    gd = gdanet_calls(int(cfg.num_query))
    calls["knn"] = calls["knn"] + gd["knn"]
    calls["gather_rows"] = calls["gather_rows"] + gd["gather_rows"]
    calls["scatter_add_rows"] = calls["scatter_add_rows"] + gd["gather_rows"]
    calls["weighted_gather_sum"] = list(gd["weighted_gather_sum"])
    return calls


def eval_calls(cfg, protocol: str) -> dict:
    """Each kernel's calls for one cloud of ``validate`` or ``test``: one
    eval request, the coarse cloud's chamfer against the ground truth and,
    in ``test`` at batch size 1, the masked chamfer of the fine cloud (two
    one-direction passes and their residual gathers) and the auction EMD,
    whose top-2 launches (one per bidding iteration, one more for the
    greedy fallback) depend on the data: ``None``, at least one."""
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    calls = {k: list(v) for k, v in request_calls(cfg).items()}
    calls["nn_bidir_argmin"].append((nq, n_fine))
    calls["gather_rows"] += [(n_fine, 3, nq), (nq, 3, n_fine)]
    calls.update(scatter_add_rows=[], nn_one_direction=[])
    if protocol == "test":
        calls["nn_one_direction"] = [(n_fine, n_fine)] * 2
        calls["gather_rows"] += [(n_fine, 3, n_fine)] * 2
        calls["auction_top2"] = None
    return calls


def batched(calls, extra) -> list:
    """(batch, shape) cases of a phase-2 check: the serving request's calls
    at batch ``B`` first (the timed ones), then ``extra``'s (batch, shape)
    pairs (a train step's at ``B_TRAIN``, the segmentation models' at
    ``B``), each once."""
    return [(B, c) for c in calls] + list(dict.fromkeys(extra))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sphere(g, b, n, dev):
    v = torch.randn(b, n, 3, generator=g, dtype=torch.float64)
    return (0.5 * v / v.norm(dim=-1, keepdim=True)).float().to(dev)


# ------------------------------------------------------------ phase 2 checks


def check_knn(calls, extra, g, dev):
    inputs = [(k, torch.randn(b, M, 3, generator=g).to(dev), torch.randn(b, S, 3, generator=g).to(dev))
              for b, (k, S, M) in batched(calls, extra)]
    err = 0.0
    for k, ref, q in inputs:
        d, i = ops.knn_with_distance(k, ref, q)
        pd, pi = ops.knn_plain(k, ref, q)
        require(torch.equal(i, pi), f"knn k={k} {tuple(q.shape)}x{tuple(ref.shape)}: indices differ")
        err = max(err, float((d - pd).abs().max()))
    require(err == 0.0, f"knn distances differ by {err}")
    inputs = inputs[:len(calls)]
    t = {
        "ms": cuda_ms(lambda: [ops.knn_with_distance(k, r, q) for k, r, q in inputs], 20),
        "plain_ms": cuda_ms(lambda: [ops.knn_plain(k, r, q) for k, r, q in inputs], 5),
        "library_ms": cuda_ms(lambda: [torch.cdist(q, r).topk(k, largest=False) for k, r, q in inputs], 20),
    }
    pairs = sum(B * S * M for _, S, M in calls)
    nbytes = sum(B * (S + M) * 12 + B * S * k * 12 for k, S, M in calls)
    return err, t, pairs * OPS_PAIR_ONE_WAY, nbytes


def check_fps(calls, extra, g, dev):
    inputs = [(torch.randn(b, N, 3, generator=g).to(dev), n) for b, (N, n) in batched(calls, extra)]
    err = 0.0
    for xyz, n in inputs:
        diff = ops.furthest_point_sample(xyz, n) - ops.fps_plain(xyz, n)
        err = max(err, float(diff.abs().max()))
        require(err == 0.0, f"fps {tuple(xyz.shape)}->{n}: picks differ")
    same = torch.ones(B, N_PARTIAL, 3, device=dev) * 0.25
    require(torch.equal(ops.furthest_point_sample(same, 512),
                        torch.zeros(B, 512, dtype=torch.int64, device=dev)),
            "fps on identical points must pick index 0 throughout")
    inputs = inputs[:len(calls)]
    t = {
        "ms": cuda_ms(lambda: [ops.furthest_point_sample(x, n) for x, n in inputs], 20),
        "plain_ms": cuda_ms(lambda: [ops.fps_plain(x, n) for x, n in inputs], 2),
        "library_ms": None,
    }
    # every step folds N distances into the cache and takes their argmax
    n_ops = sum(B * (n - 1) * N * (OPS_PAIR_ONE_WAY + 1) for N, n in calls)
    nbytes = sum(B * (N * 12 + n * 8) for N, n in calls)
    log(f"phase 2: fps runs {sum(n - 1 for _, n in calls)} dependent steps per request")
    return err, t, n_ops, nbytes


def check_gather(calls, extra, g, dev):
    inputs = []
    for b, (M, C, S) in batched(calls, extra):
        table = torch.randn(b, M, C, generator=g).to(dev)
        idx = torch.randint(0, M, (b, S), generator=g).to(dev)
        inputs.append((table, idx))
    for M, C, S in ((2048, 3, 4096), (512, 64, 8192), (512, 384, 4096)):  # clamp probes
        table = torch.randn(B, M, C, generator=g).to(dev)
        idx = torch.randint(-4, M + 4, (B, S), generator=g).to(dev)
        idx[:, :3] = torch.tensor([-1, M, M + 10**6])
        got = ops.gather_rows(table, idx)
        require(torch.equal(got, ops.gather_rows_plain(table, idx)), f"gather clamp C={C}: differs")
        require(torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 2], table[:, M - 1]),
                f"gather clamp C={C}: out-of-range rows not clamped")
    err = 0.0
    for table, idx in inputs:
        got = ops.gather_rows(table, idx)
        err = max(err, float((got - ops.gather_rows_plain(table, idx)).abs().max()))
        require(err == 0.0, f"gather {tuple(table.shape)} S={idx.shape[1]}: values differ")
    inputs = inputs[:len(calls)]
    rows = [torch.arange(B, device=dev)[:, None] for _ in inputs]
    t = {
        "ms": cuda_ms(lambda: [ops.gather_rows(tb, i) for tb, i in inputs], 50),
        "plain_ms": cuda_ms(lambda: [ops.gather_rows_plain(tb, i) for tb, i in inputs], 50),
        "library_ms": cuda_ms(lambda: [tb[r, i] for (tb, i), r in zip(inputs, rows)], 50),
    }
    nbytes = 0
    for table, idx in inputs:  # each row the indices name read once; indices read, rows written
        rows = sum(torch.unique(ix).numel() for ix in idx)
        nbytes += rows * table.shape[-1] * 4 + idx.numel() * (8 + table.shape[-1] * 4)
    return err, t, 0, nbytes


def check_bidir(calls, extra, g, dev):
    err = 0.0
    for b, (N, M) in reversed(batched(calls, extra)):  # ends on the request's clouds, timed below
        x, y = torch.randn(b, N, 3, generator=g).to(dev), torch.randn(b, M, 3, generator=g).to(dev)
        i1, i2 = ops.nn_bidir_argmin(x, y)
        p1, p2 = ops.nn_bidir_argmin_plain(x, y)
        err = max(err, float((i1 - p1).abs().max()), float((i2 - p2).abs().max()))
        require(err == 0.0, f"nn_bidir_argmin random {b}x{N}x{M}: indices differ")
    (N, M), = calls
    s1, s2 = sphere(g, 2, N, dev), sphere(g, 2, M, dev)
    i1, i2 = ops.nn_bidir_argmin(s1, s2)
    p1, p2 = ops.nn_bidir_argmin_plain(s1, s2)
    require(torch.equal(i1, p1) and torch.equal(i2, p2), "nn_bidir_argmin sphere: indices differ")
    same = torch.randn(2, N, 3, generator=g).to(dev)
    i1, i2 = ops.nn_bidir_argmin(same, same.clone())
    ident = torch.arange(N, device=dev).expand(2, N)
    require(torch.equal(i1, ident) and torch.equal(i2, ident), "identical clouds: argmin is not the identity")
    cd = float(ops.chamfer_l1(same, same.clone()))
    require(cd < 1e-9, f"identical clouds: CD-L1 {cd}")
    def library():  # one distance matrix, its argmin along both axes
        d = torch.cdist(x, y)
        return d.argmin(-1), d.argmin(1)

    t = {
        "ms": cuda_ms(lambda: ops.nn_bidir_argmin(x, y), 10),
        "plain_ms": cuda_ms(lambda: ops.nn_bidir_argmin_plain(x, y), 1),
        "library_ms": cuda_ms(library, 5),
    }
    return err, t, B * N * M * OPS_PAIR_BIDIR, B * (N + M) * 12 + B * (N + M) * 8


def check_scatter(calls, extra, g, dev):
    """scatter_add_rows at every shape one train step issues, at batch
    B_TRAIN, plus the mirror direction of each chamfer cross term."""
    Bt = B_TRAIN
    shapes = list(calls) + [(S, C, rows) for rows, C, S in calls[:3]]
    inputs, err = [], 0.0
    for rows, C, S in shapes:
        idx = torch.randint(0, rows, (Bt, S), generator=g).to(dev)
        vals = torch.randn(Bt, S, C, generator=g).to(dev)
        inputs.append((rows, idx, vals))
        got = ops.scatter_add_rows(rows, idx, vals)
        want = ops.scatter_add_rows_plain(rows, idx, vals)
        room = 1e-5 * ops.scatter_add_rows_plain(rows, idx, vals.abs())
        require(bool(((got - want).abs() <= room).all()),
                f"scatter_add_rows rows={rows} C={C} S={S}: beyond 1e-5 of the absolute sum")
        err = max(err, float((got - want).abs().max()))
    for C in (3, 384):  # a permutation: every row receives one contribution
        n = 16384 if C == 3 else 4608
        idx = torch.stack([torch.randperm(n, generator=g) for _ in range(Bt)]).to(dev)
        vals = torch.randn(Bt, n, C, generator=g).to(dev)
        got = ops.scatter_add_rows(n, idx, vals)
        require(torch.equal(got, ops.scatter_add_rows_plain(n, idx, vals)),
                f"scatter_add_rows permutation C={C}: not bit-equal")
        require(torch.equal(ops.gather_rows(got, idx), vals), "scatter then gather is not the identity")
    vals = torch.randn(2, 16384, 3, generator=g).to(dev)  # 16384 contributions to one row
    got = ops.scatter_add_rows(512, torch.full((2, 16384), 7, device=dev), vals)
    require(bool(((got[:, 7] - vals.double().sum(1).float()).abs() <= 1e-5 * vals.abs().sum(1)).all()),
            "scatter_add_rows, all indices equal: beyond 1e-5 of the absolute sum")
    got[:, 7] = 0.0
    require(int(got.count_nonzero()) == 0, "all indices equal: other rows touched")
    idx = torch.randint(-4, 516, (2, 4096), generator=g).to(dev)  # out-of-range indices clamp
    idx[:, :3] = torch.tensor([-1, 512, 512 + 10**6])
    vals = torch.randn(2, 4096, 8, generator=g).to(dev)
    got, want = ops.scatter_add_rows(512, idx, vals), ops.scatter_add_rows_plain(512, idx, vals)
    require(bool(((got - want).abs() <= 1e-5 * ops.scatter_add_rows_plain(512, idx, vals.abs())).all()),
            "scatter_add_rows clamp: differs")
    step = inputs[:len(calls)]
    offs = [(i + torch.arange(Bt, device=dev)[:, None] * r).reshape(-1) for r, i, _ in step]

    def library():
        for (r, _, v), off in zip(step, offs):
            torch.zeros(Bt * r, v.shape[-1], device=dev).index_add_(0, off, v.reshape(-1, v.shape[-1]))

    t = {
        "ms": cuda_ms(lambda: [ops.scatter_add_rows(r, i, v) for r, i, v in step], 20),
        "plain_ms": cuda_ms(lambda: [ops.scatter_add_rows_plain(r, i, v) for r, i, v in step], 20),
        "library_ms": cuda_ms(library, 20),
    }
    # values and indices read once, the output written once; one add per value
    nbytes = sum(Bt * (S * (C * 4 + 8) + rows * C * 4) for rows, C, S in calls)
    return err, t, sum(Bt * S * C for _, C, S in calls), nbytes


def check_one_direction(calls, extra, g, dev):
    """nn_one_direction: unmasked at the chamfer losses' sizes (equal to
    the plain version and to the bidirectional kernel's first direction),
    then masked, and timed over one test cloud's two masked passes."""
    for N, M in ((16384, 16384), (512, 16384)):
        x, y = torch.randn(2, N, 3, generator=g).to(dev), torch.randn(2, M, 3, generator=g).to(dev)
        i = ops.nn_one_direction(x, y)
        require(torch.equal(i, ops.nn_one_direction_plain(x, y)), f"nn_one_direction {N}x{M}: differs from plain")
        require(torch.equal(i, ops.nn_bidir_argmin(x, y)[0]), f"nn_one_direction {N}x{M}: differs from bidir i1")
    (N, M), = set(calls)
    x, y = sphere(g, 2, N, dev), sphere(g, 2, M, dev)
    wy = (torch.rand(2, M, generator=g) > 0.5).float().to(dev)
    i = ops.nn_one_direction(x, y, wy)
    require(torch.equal(i, ops.nn_one_direction_plain(x, y, wy)), "nn_one_direction random mask: differs")
    require(bool(wy.gather(1, i).eq(1).all()), "nn_one_direction: an invalid y won")
    one = torch.zeros(2, M, device=dev)
    one[0, 12345], one[1, M - 1] = 1.0, 1.0
    i = ops.nn_one_direction(x, y, one)
    require(bool(i[0].eq(12345).all() and i[1].eq(M - 1).all()), "nn_one_direction: one valid y must win everywhere")
    require(torch.equal(i, ops.nn_one_direction_plain(x, y, one)), "nn_one_direction one valid y: differs")
    x, y = torch.randn(1, N, 3, generator=g).to(dev), torch.randn(1, M, 3, generator=g).to(dev)
    wx, wy = torch.ones(1, N, device=dev), torch.ones(1, M, device=dev)

    def both(fn):
        return lambda: (fn(x, y, wy), fn(y, x, wx))

    t = {
        "ms": cuda_ms(both(ops.nn_one_direction), 10),
        "plain_ms": cuda_ms(both(ops.nn_one_direction_plain), 2),
        "library_ms": cuda_ms(lambda: (torch.cdist(x, y).argmin(-1), torch.cdist(y, x).argmin(-1)), 10),
    }
    pairs = sum(n * m for n, m in calls)
    return 0.0, t, pairs * OPS_PAIR_ONE_WAY, sum((n + m) * 12 + m * 4 + n * 8 for n, m in calls)


def check_weighted_gather_sum(calls, extra, g, dev):
    """weighted_gather_sum at the segmentation models' request shapes,
    held to 1e-5 of each element's sum of absolute terms; out-of-range
    indices (two in three in a probe) must contribute nothing. Timed over one
    superset request's calls, beside ``embedding_bag`` with per-sample
    weights (one PyTorch call for the same sum)."""
    inputs, err = [], 0.0
    for b, (S, K, M, C) in batched(calls, extra):
        idx = torch.stack([torch.stack([torch.randperm(M, generator=g)[:K] for _ in range(S)])
                           for _ in range(b)]).to(dev)  # distinct neighbours, as a top-k gives
        w, feats = torch.rand(b, S, K, generator=g).to(dev), torch.randn(b, M, C, generator=g).to(dev)
        inputs.append((w, idx, feats))
        got = ops.weighted_gather_sum(w, idx, feats)
        want = ops.weighted_gather_sum_plain(w, idx, feats)
        room = 1e-5 * ops.weighted_gather_sum_plain(w, idx, feats.abs())
        require(bool(((got - want).abs() <= room).all()),
                f"weighted_gather_sum {(b, S, K, M, C)}: beyond 1e-5 of the absolute sum")
        err = max(err, float((got - want).abs().max()))
    w, idx, feats = inputs[0]
    M = feats.shape[1]
    bad = idx.clone()  # two in three out of range: below 0, past the end
    bad[..., 0::3] = -1
    bad[..., 1::3] += M
    got, want = ops.weighted_gather_sum(w, bad, feats), ops.weighted_gather_sum_plain(w, bad, feats)
    require(bool(((got - want).abs() <= 1e-5 * ops.weighted_gather_sum_plain(w, bad, feats.abs())).all()),
            "weighted_gather_sum, out-of-range indices: differs from plain")
    only_bad = ops.weighted_gather_sum(w.masked_fill((bad >= 0) & (bad < M), 0.0), bad, feats)
    require(int(only_bad.count_nonzero()) == 0, "weighted_gather_sum: an out-of-range index contributed")
    inputs = inputs[:len(calls)]
    bags = [((i + torch.arange(i.shape[0], device=dev)[:, None, None] * f.shape[1]).reshape(-1, i.shape[-1]),
             f.reshape(-1, f.shape[-1]), w.reshape(-1, w.shape[-1])) for w, i, f in inputs]
    t = {
        "ms": cuda_ms(lambda: [ops.weighted_gather_sum(*a) for a in inputs], 50),
        "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_plain(*a) for a in inputs], 50),
        "library_ms": cuda_ms(lambda: [torch.nn.functional.embedding_bag(
            i, f, per_sample_weights=w, mode="sum") for i, f, w in bags], 50),
    }
    # weights, indices and the table read once, the output written once;
    # one multiply-add per (row, neighbour, channel)
    nbytes = sum(B * (S * K * (4 + 8) + M * C * 4 + S * C * 4) for S, K, M, C in calls)
    return err, t, sum(2 * B * S * K * C for S, K, M, C in calls), nbytes


def gather_sum_backward_inputs(cases, g, dev) -> list:
    """(w, idx, feats, cotangent) for each (batch, (S, K, M, C)) case, the
    indices distinct per row as a top-k gives them."""
    out = []
    for b, (S, K, M, C) in cases:
        idx = torch.rand(b, S, M, generator=g).argsort(dim=-1)[..., :K].contiguous().to(dev)
        w = torch.rand(b, S, K, generator=g).to(dev)
        feats, cot = torch.randn(b, M, C, generator=g).to(dev), torch.randn(b, S, C, generator=g).to(dev)
        out.append((w, idx, feats, cot))
    return out


def check_dfeats(calls, extra, g, dev):
    """weighted_gather_sum_dfeats at the superset train step's GDANet
    shapes (batch B_TRAIN, timed) and the tiny config's, held to 1e-5 of
    each element's sum of absolute terms (float32 atomics); out-of-range
    indices add nothing. Library: ``index_add_`` over the materialised
    (B, S, K, C) terms ``w * g``."""
    inputs = gather_sum_backward_inputs([(B_TRAIN, c) for c in calls] + list(extra), g, dev)
    err = 0.0
    for w, idx, feats, cot in inputs:
        M = feats.shape[1]
        got = ops.weighted_gather_sum_dfeats(w, idx, cot, M)
        want = ops.weighted_gather_sum_dfeats_plain(w, idx, cot, M)
        room = 1e-5 * ops.weighted_gather_sum_dfeats_plain(w, idx, cot.abs(), M)
        require(bool(((got - want).abs() <= room).all()),
                f"dfeats {tuple(w.shape)} M={M}: beyond 1e-5 of the absolute sum")
        err = max(err, float((got - want).abs().max()))
    w, idx, feats, cot = inputs[0]
    M = feats.shape[1]
    bad = idx.clone()  # two in three out of range
    bad[..., 0::3] = -1
    bad[..., 1::3] += M
    got = ops.weighted_gather_sum_dfeats(w, bad, cot, M)
    only_valid = ops.weighted_gather_sum_dfeats(w.masked_fill((bad < 0) | (bad >= M), 0.0), bad, cot, M)
    require(bool(((got - only_valid).abs() <= 1e-5 * ops.weighted_gather_sum_dfeats_plain(
        w, bad, cot.abs(), M)).all()), "dfeats: an out-of-range index contributed")
    timed = inputs[:len(calls)]
    flat = [((i + torch.arange(i.shape[0], device=dev)[:, None, None] * f.shape[1]).reshape(-1), w, f, c)
            for w, i, f, c in timed]

    def library():
        for rows, w_, f, c in flat:
            terms = (w_[..., None] * c[:, :, None, :]).reshape(-1, c.shape[-1])
            torch.zeros(f.shape[0] * f.shape[1], c.shape[-1], device=dev).index_add_(0, rows, terms)

    t = {
        "ms": cuda_ms(lambda: [ops.weighted_gather_sum_dfeats(w_, i, c, f.shape[1]) for w_, i, f, c in timed], 50),
        "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_dfeats_plain(w_, i, c, f.shape[1])
                                     for w_, i, f, c in timed], 20),
        "library_ms": cuda_ms(library, 20),
    }
    # w, idx and g read once, dfeats written once; a multiply and an add per term
    nbytes = sum(B_TRAIN * (S * K * (4 + 8) + S * C * 4 + M * C * 4) for S, K, M, C in calls)
    return err, t, sum(2 * B_TRAIN * S * K * C for S, K, M, C in calls), nbytes


def check_dweights(calls, extra, g, dev):
    """weighted_gather_sum_dweights at the same shapes, held to 1e-5 of
    each element's sum of absolute terms and to the same bits in two runs
    (a fixed reduction order); 0 at an out-of-range index. Library:
    ``bmm(g, featsᵀ)`` then ``gather`` at the indices."""
    inputs = gather_sum_backward_inputs([(B_TRAIN, c) for c in calls] + list(extra), g, dev)
    err = 0.0
    for w, idx, feats, cot in inputs:
        got = ops.weighted_gather_sum_dweights(idx, cot, feats)
        want = ops.weighted_gather_sum_dweights_plain(idx, cot, feats)
        room = 1e-5 * ops.weighted_gather_sum_dweights_plain(idx, cot.abs(), feats.abs())
        require(bool(((got - want).abs() <= room).all()),
                f"dweights {tuple(idx.shape)}: beyond 1e-5 of the absolute sum")
        require(torch.equal(got, ops.weighted_gather_sum_dweights(idx, cot, feats)),
                "dweights: two runs differ")
        err = max(err, float((got - want).abs().max()))
    _, idx, feats, cot = inputs[0]
    M = feats.shape[1]
    bad = idx.clone()
    bad[..., 0::3] = -1
    bad[..., 1::3] += M
    got = ops.weighted_gather_sum_dweights(bad, cot, feats)
    invalid = (bad < 0) | (bad >= M)
    require(int(got[invalid].count_nonzero()) == 0, "dweights: an out-of-range index is not 0")
    require(torch.equal(got[~invalid], ops.weighted_gather_sum_dweights(idx, cot, feats)[~invalid]),
            "dweights: the in-range entries changed with the out-of-range ones")
    timed = inputs[:len(calls)]
    t = {
        "ms": cuda_ms(lambda: [ops.weighted_gather_sum_dweights(i, c, f) for _, i, f, c in timed], 50),
        "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_dweights_plain(i, c, f) for _, i, f, c in timed], 20),
        "library_ms": cuda_ms(lambda: [torch.bmm(c, f.transpose(1, 2)).gather(2, i) for _, i, f, c in timed], 50),
    }
    # idx, g and the table read once, dw written once; a multiply and an add per term
    nbytes = sum(B_TRAIN * (S * K * (8 + 4) + S * C * 4 + M * C * 4) for S, K, M, C in calls)
    return err, t, sum(2 * B_TRAIN * S * K * C for S, K, M, C in calls), nbytes


def check_top2(calls, extra, g, dev):
    """auction_top2 at the test protocol's 16384 x 16384 (one bidding step
    of one cloud), every row live and then a small count: values bit-equal
    and indices equal on the live rows (both compute the value in one order
    without multiply-adds; max is exact). Timed with every row live, the
    first iteration's work. Library: ``cdist`` squared, minus the price,
    ``topk(2)`` (the matmul form)."""
    (N, M), = calls
    x, y = sphere(g, 1, N, dev), sphere(g, 1, M, dev)
    err = 0.0
    for price in (torch.zeros(1, M, device=dev), (torch.rand(1, M, generator=g) * 1e-3).to(dev)):
        want = ops.auction_top2_plain(x, y, price)
        for live in (N, 1000):
            got = ops.auction_top2(x, y, price, torch.tensor([live], device=dev))
            for a, b in zip(got, want):
                require(torch.equal(a[:, :live], b[:, :live]), f"auction_top2 {N}x{M} cnt={live}: differs from plain")
    full = torch.tensor([N], device=dev)
    t = {
        "ms": cuda_ms(lambda: ops.auction_top2(x, y, price, full), 10),
        "plain_ms": cuda_ms(lambda: ops.auction_top2_plain(x, y, price), 2),
        "library_ms": cuda_ms(lambda: (-(torch.cdist(x, y).square()) - price[:, None, :]).topk(2, dim=-1), 5),
    }
    # x, y and the prices read once; best, second and the index written once
    return err, t, N * M * OPS_PAIR_TOP2, N * 12 + M * 16 + N * 16


# ------------------------------------------------------------- phase 3 path


def make_requests(cfg, seed: int, n_requests: int, b: int = B) -> list:
    """``n_requests`` requests of ``b`` synthetic samples for ``cfg``'s
    model: dicts of stacked numpy arrays, the model's inputs (partial cloud,
    and an image and a class one-hot where it takes them) and ``gt``."""
    data = SyntheticPCN({"N_POINTS": int(cfg.num_points), "N_PARTIAL": N_PARTIAL,
                         "LENGTH": b * n_requests, "SEED": seed, "WITH_IMG": "Img" in cfg.NAME,
                         "WITH_CLS": "Seg" in cfg.NAME, "others": {"subset": "test"}})
    samples = [data.get(i, None)[2] for i in range(len(data))]
    return [{k: np.stack([s[k] for s in samples[r * b:(r + 1) * b]]) for k in samples[0]}
            for r in range(n_requests)]


def model_args(model, batch: dict, dev) -> list:
    """The model's inputs of a request (``model.inputs``), on ``dev``."""
    return [torch.from_numpy(batch[k]).to(dev) for k in model.inputs]


def serve(model, cfg, batches, dev):
    """Answer each request; returns per-request seconds and the metrics."""
    secs, scores = [], []
    n_fine, nq = int(cfg.num_points), int(cfg.num_query)
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            coarse, fine = model(*model_args(model, batch, dev))
            f, l1, l2 = eval_metric_suite(fine, torch.from_numpy(batch["gt"]).to(dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        n = batch["partial"].shape[0]
        require(tuple(coarse.shape) == (n, nq, 3), f"coarse shape {tuple(coarse.shape)}")
        require(tuple(fine.shape) == (n, n_fine, 3), f"fine shape {tuple(fine.shape)}")
        require(bool(torch.isfinite(coarse).all() and torch.isfinite(fine).all()), "non-finite output")
        scores.append((float(f), float(l1), float(l2)))
        require(all(np.isfinite(v) for v in scores[-1]), f"non-finite metrics {scores[-1]}")
    return secs, scores


def cpu_agreement(model, cpu_model, batch: dict, dev) -> dict:
    """The card's answer to one request against the CPU's (same weights).

    Near-tied ranking scores (all about 0.5 at a random init) may be
    ordered differently on the two devices, which permutes the queries and
    their patches but not the clouds as sets; so the clouds are compared
    as sets: the share of points of each with a counterpart in the other
    within 1e-4 (float32 rounding through 14 blocks is far below that)."""
    with torch.inference_mode():
        gc, gf = model(*model_args(model, batch, dev))
        cc, cf = cpu_model(*model_args(cpu_model, batch, "cpu"))
        out = {}
        for name, a, b in (("coarse", gc, cc.to(dev)), ("fine", gf, cf.to(dev))):
            d1, d2, _, _ = ops.nn_distance_eval(a, b)
            out[f"{name}_matched"] = float(min((d1 < 1e-8).float().mean(), (d2 < 1e-8).float().mean()))
            out[f"{name}_hausdorff"] = float(max(d1.max(), d2.max()).sqrt())
        out["cd_l1_card"] = float(eval_metric_suite(gf, torch.from_numpy(batch["gt"]).to(dev))[1])
        out["cd_l1_cpu"] = float(eval_metric_suite(cf, torch.from_numpy(batch["gt"]))[1])
    return out


def profile_run(run) -> dict:
    """Device time of ``run()`` (which returns its wall seconds, ending in
    a synchronise) by kernel name (torch.profiler), the ported kernels'
    share of it, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    # device events without the profiler's own annotations (e.g. the
    # optimizer's step range, which is no kernel)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer.")]
    if not kernels:
        return {"device_time": "not measured: the profiler saw no device activity"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    ours = {n: sum(v for k, v in by_name.items() if n in k) / 1e3 for n in PORTED_KERNEL_NAMES}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3, "kernel_sum_ms": total / 1e3,
        "idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
        "ported_kernels_share": sum(ours.values()) * 1e3 / total, "ported_kernels_ms": ours,
        "launches": len(kernels), "top": [[k[:80], v / 1e3] for k, v in top],
    }


# ------------------------------------------------------------ phase 5 path


def card_vs_cpu_selections(model, cpu_model, batch: dict, dev) -> dict:
    """:func:`cpu_agreement` for a segmentation model, counting GDANet's
    discrete selections (its feature-space kNN rows and the GDM's sharp and
    gentle orders, all through ``top_k_indices``) that differ between the
    card's and the CPU's run."""
    picks = {"cuda": [], "cpu": []}
    original = port_gdanet.top_k_indices

    def record(scores, k):
        idx = original(scores, k)
        picks[scores.device.type].append(idx.cpu())
        return idx

    port_gdanet.top_k_indices = record
    try:
        out = cpu_agreement(model, cpu_model, batch, dev)
    finally:
        port_gdanet.top_k_indices = original
    require(len(picks["cuda"]) == len(picks["cpu"]) > 0, "GDANet's selections were not recorded")
    out["gdanet_selections"] = sum(a.numel() for a in picks["cpu"])
    out["gdanet_selections_differ"] = [int((a != b).sum()) for a, b in zip(picks["cuda"], picks["cpu"])]
    return out


def branch_phase(seed: int, dev, card: str):
    """Phase 5: the superset's requests, profile and card-vs-CPU check,
    then one request each of the other two branch models; returns each
    path's launch counts and the superset's summary."""
    cfg = cfg_from_yaml_file(SUPERSET).model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 5: {SUPERSET} built on {dev}, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    batches = make_requests(cfg, seed, REQUESTS + 1)
    serve(model, cfg, batches[:1], dev)  # warm-up request (cuDNN and cuBLAS handles)
    _build.reset_launches()
    secs, scores = serve(model, cfg, batches[1:], dev)
    calls = dict(request_calls(cfg), scatter_add_rows=[], nn_one_direction=[])
    counts = {cfg.NAME: check_launches("the superset's requests", calls, REQUESTS)}
    for r, (sec, (f, l1, l2)) in enumerate(zip(secs, scores)):
        log(f"phase 5: request {r}: {B} x ({N_PARTIAL} points, 224x224 image, class) -> "
            f"{B}x{int(cfg.num_points)} in {sec * 1e3:.1f} ms; CD-L1 {l1:.4f} CD-L2 {l2:.4f} F@0.01 {f:.4f}")
    log(f"phase 5: median superset request {statistics.median(secs) * 1e3:.1f} ms on {card}; launches "
        f"per request {json.dumps({k: v // REQUESTS for k, v in counts[cfg.NAME].items()})}")
    prof = profile_run(lambda: serve(model, cfg, [batches[1]], dev)[0][0])
    log("phase 5: one profiled superset request: " + json.dumps(prof))

    # batch 2 against the CPU, the last ranking layer scaled by 1000 on both
    # (as card_vs_cpu_step does) so that near-tied scores pick the same queries
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    for m in (model, cpu_model):
        with torch.no_grad():
            m.base_model.query_ranking[4].weight.mul_(1000.0)
    agree = card_vs_cpu_selections(model, cpu_model, {k: v[:2] for k, v in batches[1].items()}, dev)
    log("phase 5: card vs CPU at batch 2: " + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "the superset: the card's clouds disagree with the CPU's")
    require(abs(agree["cd_l1_card"] - agree["cd_l1_cpu"]) <= 1e-2 * agree["cd_l1_cpu"],
            "the superset: the card's CD-L1 disagrees with the CPU's")
    del model, cpu_model

    for path in BRANCH_CONFIGS:
        bcfg = cfg_from_yaml_file(path).model
        m = build_model(bcfg, device="cuda", seed=seed)
        reqs = make_requests(bcfg, seed, 2)
        serve(m, bcfg, reqs[:1], dev)
        _build.reset_launches()
        (sec,), ((f, l1, l2),) = serve(m, bcfg, reqs[1:], dev)
        calls = dict(request_calls(bcfg), scatter_add_rows=[], nn_one_direction=[])
        counts[bcfg.NAME] = check_launches(f"a {bcfg.NAME} request", calls, 1)
        log(f"phase 5: {bcfg.NAME}: one request of {B} in {sec * 1e3:.1f} ms; CD-L1 {l1:.4f} "
            f"F@0.01 {f:.4f}; launches {json.dumps(counts[bcfg.NAME])}")
        del m
    summary = {"batch": B, "request_ms": [t * 1e3 for t in secs],
               "median_request_ms": statistics.median(secs) * 1e3,
               "profiled_request": {k: v for k, v in prof.items() if k != "top"},
               "card_vs_cpu": {k: agree[k] for k in ("coarse_matched", "fine_matched",
                                                      "gdanet_selections", "gdanet_selections_differ")}}
    return counts, summary


# ------------------------------------------------------------ phase 4 path


def timed_step(runner, batch, epoch_f, noise=None):
    """One ``Runner.train_step`` between synchronises: (seconds, metrics as floats)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = runner.train_step(batch, epoch_f, noise=noise)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k: float(v) for k, v in m.items()}


def check_launches(what: str, want: dict, times: int) -> dict:
    """The launch counts since the last reset against ``times`` runs of the
    call table ``want`` (a kernel it does not name: none; ``None``: a
    data-dependent count, at least one a run); returns the counts."""
    got = _build.launches()
    for name in _build.KERNELS:
        calls = want.get(name, [])
        if calls is None:
            require(got[name] >= times, f"{name}: {got[name]} launches in {what}, at least {times} expected")
        else:
            require(got[name] == len(calls) * times,
                    f"{name}: {got[name]} launches in {what}, the table says {len(calls) * times}")
    return got


def train_phase(config, seed: int, dev, workdir: str) -> dict:
    """Phase 4: train steps, validate, test, checkpoint round trip through
    the runner; returns the launch counts of each part and the summary of
    the timed steps."""
    cfg = config.model
    swap_synthetic(config, train_len=B_TRAIN * (TRAIN_STEPS + 2))
    config.dataset.train.others.bs = B_TRAIN
    for split in ("val", "test"):
        config.dataset[split].LENGTH = EVAL_CLOUDS
        config.dataset[split].others.bs = 1
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, emd=True,
                                 experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, val_loader = dataset_builder(args, config.dataset.val)
    _, test_loader = dataset_builder(args, config.dataset.test)
    t0 = time.perf_counter()
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    model = runner.model
    log(f"phase 4: runner built on {dev} in {time.perf_counter() - t0:.1f} s; "
        f"{len(train_loader)} batches of {B_TRAIN} x {N_PARTIAL} -> {int(cfg.num_points)}")
    batches = [b for _, _, b in train_loader]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bn = model.increase_dim[1]
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())
    calls = train_step_calls(cfg)

    secs, _ = timed_step(runner, batches[0], 0.0)  # warm-up (cuBLAS handles, caches)
    log(f"phase 4: warm-up step {secs * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for i, batch in enumerate(batches[1:1 + TRAIN_STEPS]):
        secs, m = timed_step(runner, batch, (i + 1) / len(train_loader))
        times.append(secs)
        require(all(np.isfinite(v) for v in m.values()), f"step {i}: non-finite {m}")
        log(f"phase 4: step {i}: {secs * 1e3:.1f} ms; sparse {m['sparse_loss']:.5f} dense "
            f"{m['dense_loss']:.5f} grad norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")
    counts = {"train": check_launches("the train steps", calls, TRAIN_STEPS)}
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4: median step {statistics.median(times) * 1e3:.1f} ms at batch {B_TRAIN}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps({k: v // TRAIN_STEPS for k, v in counts['train'].items()})}")

    dead = ("query_ranking", "encoder.norm")  # no gradient by construction / never applied
    for name, p in model.named_parameters():
        if any(d in name for d in dead):
            require(p.grad is None and torch.equal(p, before[name]), f"{name} was touched")
        else:
            require(not torch.equal(p, before[name]), f"{name} did not change in {TRAIN_STEPS + 1} steps")
    require(not torch.equal(bn.running_mean, bn_before[0]) and not torch.equal(bn.running_var, bn_before[1]),
            "BN running statistics did not change")

    path = runner.save("ckpt-smoke", 0, None, None)
    other = port_runner.Runner(args, config, logger="silent")
    other.make_train_state(len(train_loader))
    meta = load_checkpoint(path, other.model, other.optimizer)
    require(meta["step"] == TRAIN_STEPS + 1, f"checkpoint step {meta['step']}")
    for (n, a), (_, b) in zip(model.state_dict().items(), other.model.state_dict().items()):
        require(torch.equal(a, b), f"checkpoint: {n} differs")
    want, got = runner.optimizer.state_dict(), other.optimizer.state_dict()
    require(want["param_groups"] == got["param_groups"] and want["state"].keys() == got["state"].keys(),
            "checkpoint: optimizer layout differs")
    for k, st in want["state"].items():
        for field, v in st.items():
            other_v = got["state"][k][field]
            require(v.device == other_v.device and torch.equal(v, other_v),
                    f"checkpoint: optimizer state {k}.{field} differs")
    log(f"phase 4: checkpoint round trip bit-equal ({len(want['state'])} parameters with moments)")
    del other

    _build.reset_launches()
    metrics = port_runner.validate(runner, val_loader, 0, "silent")
    counts["validate"] = check_launches("validate", eval_calls(cfg, "validate"), EVAL_CLOUDS)
    _build.reset_launches()
    scores = port_runner.test(runner, test_loader, args, config, "silent")
    counts["test"] = check_launches("test", eval_calls(cfg, "test"), EVAL_CLOUDS)
    require(all(np.isfinite(v) for v in metrics.state_dict().values()), f"validate: {metrics}")
    require(all(np.isfinite(v) for v in scores.values()), f"test: {scores}")
    require(scores["EMDistance"] > 0, f"test: EMDistance {scores['EMDistance']}")
    log(f"phase 4: validate on {EVAL_CLOUDS} clouds: {metrics}; test on {EVAL_CLOUDS} clouds at "
        f"batch 1 (masked path, {counts['test']['nn_one_direction']} one-direction launches; EMD, "
        f"{counts['test']['auction_top2']} top-2 launches): "
        + json.dumps({k: float(v) for k, v in scores.items()}))
    emd = emd_check(runner, next(iter(test_loader))[2], dev)
    log("phase 4: EMD on one test cloud: " + json.dumps({k: v for k, v in emd.items() if k != "profile"}))
    log("phase 4: one profiled EMD: " + json.dumps(emd["profile"]))

    batch = batches[1 + TRAIN_STEPS]
    prof = profile_run(lambda: timed_step(runner, batch, 0.9)[0])
    log("phase 4: one profiled train step: " + json.dumps(prof))
    summary = {"batch": B_TRAIN, "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in prof.items() if k != "top"},
               "emd": {k: emd[k] for k in ("emd_ms", "top2_launches", "iterations", "converged")}}
    return counts, summary


def emd_check(runner, batch, dev) -> dict:
    """The auction EMD of one test cloud (the model's fine cloud against
    the 16384-point ground truth): its time (host clock between
    synchronises, three runs), the active bidders of every iteration, the
    top-2 launches, and the assignment through the kernel against the same
    loop through the plain top-2 on the card; then one profiled run."""
    from imgadapointr_tpu_torch.ops import emd as port_emd

    with torch.inference_mode():
        _, dense = runner.model.eval()(*model_args(runner.model, {k: v.numpy() for k, v in batch.items()}, dev))
    gt = batch["gt"].to(dev)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        assign = port_emd._auction_batch(dense, gt, EMD_EPS, EMD_ITERATIONS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _build.launches()["auction_top2"]
    active = []

    def counting(x, y, price, cnt=None):
        active.append(None if cnt is None else int(cnt.sum()))
        return ops.auction_top2(x, y, price, cnt)

    require(torch.equal(port_emd._auction_batch(dense, gt, EMD_EPS, EMD_ITERATIONS, top2=counting), assign),
            "EMD: two runs of the auction differ")
    plain = port_emd._auction_batch(dense, gt, EMD_EPS, EMD_ITERATIONS, top2=ops.auction_top2_plain)
    require(torch.equal(plain, assign), "EMD: the kernel path's assignment differs from the plain path's")
    iterations = sum(a is not None for a in active)
    metric = float(ops.emd_distance_metric(dense, gt)) * 1000.0
    require(np.isfinite(metric) and metric > 0, f"EMD x1000 {metric}")

    def one_auction():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port_emd._auction_batch(dense, gt, EMD_EPS, EMD_ITERATIONS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof = profile_run(one_auction)
    return {"n": int(dense.shape[1]), "m": int(gt.shape[1]), "emd_x1000": metric,
            "emd_ms": [t * 1e3 for t in secs], "top2_launches": launches, "iterations": iterations,
            "converged": None not in active, "active_first": active[:8], "active_last": active[-4:],
            "unique_items": int(assign.unique().numel()), "assignment_equals_plain": True,
            "profile": {k: v for k, v in prof.items() if k != "top"} | {"top": prof.get("top", [])[:5]}}


def card_vs_cpu_step(config, seed: int, workdir: str, grad_norm_tol: float = 1e-3) -> dict:
    """One train step at batch 2 and full width on the card against the
    same step on the CPU through the plain versions: same weights, batch
    (with images and class one-hots where the model takes them) and jitter
    noise. The last ranking layer is scaled by 1000 on both (as the JAX
    package's parity harness does): at a random init the ranking scores
    nearly tie, and float32 rounding would otherwise pick different queries
    on the two devices. A model with GDANet counts its selections that
    differ between the two runs."""
    out, grads = {}, {}
    name = config.model.NAME
    data = SyntheticPCN({"N_POINTS": int(config.model.num_points), "N_PARTIAL": N_PARTIAL,
                         "LENGTH": 2, "SEED": seed + 1, "WITH_IMG": "Img" in name,
                         "WITH_CLS": "Seg" in name, "others": {"subset": "train"}})
    samples = [data.get(i, None)[2] for i in range(2)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}
    noise = torch.randn(2, DENOISE, 3, generator=torch.Generator().manual_seed(seed))
    picks = {"cuda": [], "cpu": []}
    original = port_gdanet.top_k_indices

    def record(scores, k):
        idx = original(scores, k)
        picks[scores.device.type].append(idx.cpu())
        return idx

    port_gdanet.top_k_indices = record
    try:
        for device in ("cuda", "cpu"):
            args = types.SimpleNamespace(device=device, seed=seed, experiment_path=workdir)
            runner = port_runner.Runner(args, config, logger="silent")
            runner.make_train_state(1)
            with torch.no_grad():
                runner.model.base_model.query_ranking[4].weight.mul_(1000.0)
            m = runner.train_step(batch, 0.0, noise=noise)
            out[device] = {k: float(m[k]) for k in ("total_loss", "grad_norm")}
            grads[device] = {n: p.grad.detach().cpu() for n, p in runner.model.named_parameters()
                             if p.grad is not None}
            del runner
    finally:
        port_gdanet.top_k_indices = original
    if picks["cpu"]:
        require(len(picks["cuda"]) == len(picks["cpu"]), "GDANet's selections were not all recorded")
        out["gdanet_selections"] = sum(a.numel() for a in picks["cpu"])
        out["gdanet_selections_differ"] = [int((a != b).sum()) for a, b in zip(picks["cuda"], picks["cpu"])]
    # the gradients themselves (unclipped where the norm is under the clip's 10)
    require(grads["cuda"].keys() == grads["cpu"].keys(), "card vs CPU: different parameters got gradients")
    diff = {n: float((g - grads["cpu"][n]).norm()) for n, g in grads["cuda"].items()}
    out["grad_diff_over_norm"] = sum(d * d for d in diff.values()) ** 0.5 / out["cpu"]["grad_norm"]
    out["grad_diff_worst"] = sorted(((d / out["cpu"]["grad_norm"], n) for n, d in diff.items()), reverse=True)[:3]
    for k, tol in (("total_loss", 1e-4), ("grad_norm", grad_norm_tol)):
        rel = abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
        out[f"{k}_rel_diff"] = rel
        require(rel <= tol, f"card vs CPU: {k} differs by {rel:.2e} relative (limit {tol})")
    return out


# ------------------------------------------------------------ phase 6 path


def superset_train_phase(seed: int, dev, card: str, workdir: str):
    """Phase 6: the superset's train steps at batch B_TRAIN through the
    runner, its launch table, GDANet frozen, a profiled step and the peak
    memory, then one step at batch 2 against the CPU; returns the launch
    counts and the summary."""
    config = cfg_from_yaml_file(SUPERSET)
    cfg = config.model
    swap_synthetic(config, train_len=B_TRAIN * (TRAIN_STEPS + 2))
    config.dataset.train.others.bs = B_TRAIN
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    t0 = time.perf_counter()
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    model = runner.model
    batches = [b for _, _, b in train_loader]
    log(f"phase 6: {SUPERSET} runner built in {time.perf_counter() - t0:.1f} s; {len(batches)} batches "
        f"of {B_TRAIN} x ({N_PARTIAL} points, 224x224 image, class) -> {int(cfg.num_points)}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stem_bn = model.base_model.im_encoder.base[1]
    stem_before = stem_bn.running_mean.clone()

    secs, _ = timed_step(runner, batches[0], 0.0)
    log(f"phase 6: warm-up step {secs * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for i, batch in enumerate(batches[1:1 + TRAIN_STEPS]):
        secs, m = timed_step(runner, batch, (i + 1) / len(train_loader))
        times.append(secs)
        require(all(np.isfinite(v) for v in m.values()), f"superset step {i}: non-finite {m}")
        log(f"phase 6: step {i}: {secs * 1e3:.1f} ms; sparse {m['sparse_loss']:.5f} dense "
            f"{m['dense_loss']:.5f} grad norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")
    counts = {"superset_train": check_launches("the superset's train steps", superset_train_calls(cfg),
                                               TRAIN_STEPS)}
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 6: median superset step {statistics.median(times) * 1e3:.1f} ms at batch {B_TRAIN} on "
        f"{card}; max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps({k: v // TRAIN_STEPS for k, v in counts['superset_train'].items()})}")

    dead = ("query_ranking", "encoder.norm")
    for name, p in model.named_parameters():
        if "segmentator" in name:
            require(not p.requires_grad and p.grad is None and torch.equal(p, before[name]),
                    f"{name}: the frozen GDANet was touched")
        elif any(d in name for d in dead):
            require(p.grad is None and torch.equal(p, before[name]), f"{name} was touched")
        else:
            require(not torch.equal(p, before[name]), f"{name} did not change in {TRAIN_STEPS + 1} steps")
    require(not torch.equal(stem_bn.running_mean, stem_before), "ResNet's BN statistics did not change")

    prof = profile_run(lambda: timed_step(runner, batches[1 + TRAIN_STEPS], 0.9)[0])
    log("phase 6: one profiled superset step: " + json.dumps(prof))
    del runner, model, batches
    torch.cuda.empty_cache()
    agree = card_vs_cpu_step(cfg_from_yaml_file(SUPERSET), seed, workdir, SUPERSET_GRAD_NORM_TOL)
    log("phase 6: card vs CPU, one superset step at batch 2: " + json.dumps(agree))
    summary = {"batch": B_TRAIN, "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in prof.items() if k != "top"},
               "card_vs_cpu": {k: agree[k] for k in ("total_loss_rel_diff", "grad_norm_rel_diff",
                                                     "gdanet_selections", "gdanet_selections_differ")}}
    return counts, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # ---- phase 1: checks
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the port's numerics are fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; {card}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: built {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.1f} s "
        f"({_build.build()})")

    # ---- phase 2: each kernel against its plain version
    cfg = cfg_from_yaml_file(CONFIG).model
    calls = request_calls(cfg)
    n_fine = int(cfg.num_points)
    # the kernels serving does not run: one train step's scatters, and the
    # two masked passes of one test cloud at batch size 1
    train_calls = train_step_calls(cfg)
    # the segmentation models' GDANet pass: on the superset's ranked
    # queries and on SegEncAdaPoinTr's encoder centres
    seg_cfgs = [cfg_from_yaml_file(p).model for p in (SUPERSET, BRANCH_CONFIGS[0])]
    seg = [gdanet_calls(int(c.num_query)) for c in seg_cfgs[:1]]
    seg += [gdanet_calls(int(c.center_num[1])) for c in seg_cfgs[1:]]
    check_calls = dict(calls, scatter_add_rows=train_calls["scatter_add_rows"],
                       nn_one_direction=[(n_fine, n_fine)] * 2,
                       weighted_gather_sum=seg[0]["weighted_gather_sum"])
    # shapes the timed calls do not cover: a train step's at B_TRAIN, the
    # segmentation models' GDANet pass at B
    extra = {name: [(B_TRAIN, c) for c in train_calls[name]]
             + [(B, c) for table in seg for c in table.get(name, [])] for name in calls}
    extra["weighted_gather_sum"] = [(B, c) for c in seg[1]["weighted_gather_sum"]]
    # the gather-sum's backward at the shapes a superset train step gives its
    # forward, at B_TRAIN (timed), and the tiny superset config's at batch 2
    # (no step reaches that backward: see superset_train_calls); the top-2
    # at one bidding step of one test cloud
    tiny = cfg_from_yaml_file("cfgs/SegImgPCN_models/ImgEncSegDec-tiny.yaml").model
    bwd = superset_train_calls(seg_cfgs[0])["weighted_gather_sum"]
    bwd_extra = [(2, c) for c in gdanet_calls(int(tiny.num_query))["weighted_gather_sum"][:1]]
    check_calls.update(weighted_gather_sum_dfeats=bwd, weighted_gather_sum_dweights=bwd,
                       auction_top2=[(n_fine, n_fine)])
    extra.update(weighted_gather_sum_dfeats=bwd_extra, weighted_gather_sum_dweights=bwd_extra)
    g = torch.Generator().manual_seed(args.seed)
    checks = {"knn": check_knn, "fps": check_fps, "gather_rows": check_gather,
              "nn_bidir_argmin": check_bidir, "scatter_add_rows": check_scatter,
              "nn_one_direction": check_one_direction,
              "weighted_gather_sum": check_weighted_gather_sum,
              "weighted_gather_sum_dfeats": check_dfeats, "weighted_gather_sum_dweights": check_dweights,
              "auction_top2": check_top2}
    results = {}
    for name, check in checks.items():
        results[name] = err, t, _, _ = check(check_calls[name], extra.get(name, []), g, dev)
        n_shapes = len(batched(check_calls[name], extra.get(name, [])))
        log(f"phase 2: {name}: agrees with plain over {n_shapes} shapes "
            f"and probes (max abs err {err:.3g}); {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']})")

    # ---- phase 3: the serving path at full width
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: {CONFIG} built on {dev}, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    batches = make_requests(cfg, args.seed, REQUESTS + 1)
    serve(model, cfg, batches[:1], dev)  # warm-up request (cuBLAS handles, caches)
    _build.reset_launches()
    secs, scores = serve(model, cfg, batches[1:], dev)
    launches = check_launches("the serving requests",
                              dict(calls, scatter_add_rows=[], nn_one_direction=[]), REQUESTS)
    for r, (s, (f, l1, l2)) in enumerate(zip(secs, scores)):
        log(f"phase 3: request {r}: {B}x{N_PARTIAL} -> {B}x{int(cfg.num_points)} in {s * 1e3:.1f} ms; "
            f"CD-L1 {l1:.4f} CD-L2 {l2:.4f} F@0.01 {f:.4f} (x1000 for CD)")
    log(f"phase 3: median request {statistics.median(secs) * 1e3:.1f} ms on {card}; "
        f"launches per request {json.dumps({k: v // REQUESTS for k, v in launches.items()})}")

    # one request against the same weights on the CPU, plain versions throughout
    agree = cpu_agreement(model, build_model(cfg, device="cpu", seed=args.seed),
                          {k: v[:1] for k, v in batches[1].items()}, dev)
    log("phase 3: card vs CPU on one cloud: " + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "the card's clouds disagree with the CPU's")
    require(abs(agree["cd_l1_card"] - agree["cd_l1_cpu"]) <= 1e-2 * agree["cd_l1_cpu"],
            "the card's CD-L1 disagrees with the CPU's")
    prof = profile_run(lambda: serve(model, cfg, [batches[1]], dev)[0][0])
    log("phase 3: one profiled request: " + json.dumps(prof))
    serve_summary = {"batch": B, "median_request_ms": statistics.median(secs) * 1e3,
                     "device_busy_ms": prof.get("device_busy_ms"), "launches": prof.get("launches")}
    del model

    # ---- phase 4: the training path at full width
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts, train_summary = train_phase(cfg_from_yaml_file(CONFIG), args.seed, dev, workdir)
        agree = card_vs_cpu_step(cfg_from_yaml_file(CONFIG), args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("phase 4: card vs CPU, one step at batch 2: " + json.dumps(agree))

    # ---- phase 5: the image and segmentation serving path at full width
    branch_counts, superset_summary = branch_phase(args.seed, dev, card)
    counts.update(branch_counts)

    # ---- phase 6: the superset's training at full width
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        superset_counts, superset_train_summary = superset_train_phase(args.seed, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    counts.update(superset_counts)

    kernels = []
    for name in _build.KERNELS:
        err, t, n_ops, nbytes = results[name]
        op_ms, byte_ms = n_ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # over every driven path; each path's counts were read on their own
            "launches": launches[name] + sum(c[name] for c in counts.values()),
            "launches_per_request": launches[name] // REQUESTS,
            "launches_per_superset_request": counts["ImgEncSegDecAdaPoinTrVariableLoss"][name] // REQUESTS,
            "launches_per_train_step": counts["train"][name] // TRAIN_STEPS,
            "launches_per_superset_train_step": counts["superset_train"][name] // TRAIN_STEPS,
            "launches_validate": counts["validate"][name], "launches_test": counts["test"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": t["library_ms"],
        })
        if name in NOT_ON_A_PATH:
            require(kernels[-1]["launches"] == 0, f"{name}: launched on a path the tables say it is not on")
            kernels[-1]["not_on_a_path"] = NOT_ON_A_PATH[name]
    # the paths' readings again, so that the end of the output carries them
    log("summary: " + json.dumps({"card": card, "serving": serve_summary, "training": train_summary,
                                  "card_vs_cpu_step": {k: agree[k] for k in (
                                      "total_loss_rel_diff", "grad_norm_rel_diff")},
                                  "superset_serving": superset_summary,
                                  "superset_training": superset_train_summary}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
