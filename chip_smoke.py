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
   cloud's; the weighted gather-sum: one superset request's). The row
   gather, the bidirectional argmin, the gather-sum's ``dweights`` and the
   auction top-2 are also timed with the host taken out, by replaying
   their calls and their library call captured in a CUDA graph, in turns
   with the host loop on the same card; their ``ms`` and ``library_ms``
   are the replay times (the top-2 also at its smallest live width), and
   the gather prints the host
   cost of one 1-row call on its direct route and on the route through
   the autograd Function and ``launch_with_context`` (the launch path as it
   was before it resolved entries once and skipped the lock and the
   device context);
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
   norm ``SUPERSET_GRAD_NORM_TOL``, GDANet's differing selections counted);
7. ``AdaPoinTr-deform`` (:func:`deform_config`: the flagship with
   deformable local attention, every token in every call form) at full
   width: ``REQUESTS`` requests of ``B`` with metrics and their launch table
   (8 fused 3-NN interpolations a request), a profiled request, one request
   at batch 2 against the CPU (clouds as sets); 1 warm-up and
   ``TRAIN_STEPS`` steps of ``Runner.train_step`` at batch 16 with their
   table (8 fused 3-NN calls and 8 of their VJP, ``dfeats``), the offset
   nets and ``proj_v_off`` without gradient and untouched, every other
   trainable parameter moved, a profiled step, and one step at batch 2
   against the CPU (loss 1e-4, gradient norm 1e-3, relative).

Phase 2 also holds the gather-sum's two backward kernels (``dfeats`` at
K = 3 on the deformable train step's 3-NN shapes, where it is the
interpolation's VJP, and both at the superset train step's GDANet shapes
and the tiny config's; 1e-5 of each element's absolute sum, ``dweights``
the same bits in two runs), the auction top-2
(16384 x 16384 at 16384, about 3500 and about 1060 live rows, a batch of 3
with counts (0, 1, N), item counts off the kernel's chunk and below one
chunk, duplicated items whose ties meet in the chunk merge; values
bit-equal, indices equal, the same bits in two runs), the fused 3-NN interpolation (every deformable call's
shape at serving and train batch, and probes; indices equal, values
bit-equal) and the matmul-form argmin of the opt-in eval chamfer (8 x 16384
x 16384 and a ragged shape; indices equal) against their plain versions.
Phase 4's test protocol runs the auction EMD at 16384 x 16384 on each
cloud: its time per cloud, iterations, top-2 launches, the top-2's device
time in one profiled auction, and one cloud's assignment through the
kernel equal to the plain path's (and to a second run's). Phase 4 then runs
``validate`` and ``test`` again with ``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER``
set for those calls only: the matmul-form kernel's launches replace the
exact kernel's in the eval suite, CD-L1 and CD-L2 x1000 stay within 1e-3 of
the exact run's, and the test table (exact F-score) is the exact run's.

Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
from imgadapointr_tpu_torch.nn.blocks import _parse_style
from imgadapointr_tpu_torch.ops import _build, pointops
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
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s,
# float32 outside the tensor cores, and dense bf16 products with float32
# sums in the tensor cores (the rate of the matmul-form argmin's cross term,
# whatever unit the kernel computes it on).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16_TC = 989e12
# operations per candidate pair: 3 subtracts, 3 multiplies, 2 adds, and
# one compare per direction the pair is ranked in
OPS_PAIR_ONE_WAY = 9
OPS_PAIR_BIDIR = 10
# the auction's bid value per pair: 3 subtracts, 3 multiplies, 2 adds, the
# price's subtract, and a compare
OPS_PAIR_TOP2 = 10
# live bidders of the auction at 16384 x 16384 (phase 4's log of one test
# cloud): every row at the first iteration, about 3500 by the fifth, about
# 1060 at the hundredth
TOP2_LIVE = (16384, 3500, 1060)
EMD_EPS, EMD_ITERATIONS = 0.005, 100  # the test protocol's auction
# Card against CPU, one superset step at batch 2: GDANet ranks its feature
# neighbours by the float32 matmul form on both devices, and at near-ties the
# two pick different neighbours (151 of 227,328 selections in the serving
# check); each such pick changes a point's edge feature, its max-pool and the
# gradient that flows back through it, so the gradient norm is held to 10x
# the flagship's 1e-3; the losses keep the flagship's 1e-4.
SUPERSET_GRAD_NORM_TOL = 1e-2

# the matmul-form distance per pair: the cross term is a bf16 product of
# inner length 9 with float32 sums (3 dot products of 3, 9 multiplies and 8
# adds), a tensor-core operation; then a multiply, a subtract and an add,
# and one compare per direction, in float32
OPS_PAIR_MXU_TC = 17
OPS_PAIR_MXU_F32 = 5
# the fused 3-NN's weighted sum per output element: 3 multiplies, 2 adds
OPS_INTERP_ELEM = 5
# the deformable config's block lists (cfgs/PCN_models/AdaPoinTr.yaml otherwise)
DEFORM_LISTS = {
    "encoder": ["attn-rw_deform", "attn-deform", "attn-deform_graph", "attn", "attn", "attn"],
    "self": ["attn-deform", "attn-deform_graph", "attn-rw_deform"] + ["attn"] * 5,
    "cross": ["attn-deform", "attn-deform_graph"] + ["attn"] * 6,
}
MXU_FLAG = "IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER"

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
    "three_nn_interpolate": ("imgadapointr_tpu_torch/csrc/three_nn_interpolate.cu",
                             "imgadapointr_tpu/ops/pallas/nn_distance.py:451"),
    "nn_bidir_mxu": ("imgadapointr_tpu_torch/csrc/nn_bidir_mxu.cu",
                     "imgadapointr_tpu/ops/pallas/nn_distance.py:318"),
}
# Kernels that no driven path launches, and why; phase 2 holds them against
# their plain versions all the same
NOT_ON_A_PATH = {
    "weighted_gather_sum_dweights":
        "the weighted gather-sum's weight gradient: the GDM's neighbour sum feeds only a top-k ranking, "
        "so no train step's cotangent reaches it (the JAX package's gradient never calls its Pallas VJP "
        "either); the 3-NN interpolation's VJP needs only dfeats",
}
PORTED_KERNEL_NAMES = ("nn_bidir_kernel", "knn_kernel", "fps_kernel", "gather_rows",
                       "scatter_add_rows", "nn_one_direction", "weighted_gather_sum",
                       "dfeats_kernel", "dweights_kernel", "auction_top2", "three_nn_interp_kernel",
                       "nn_bidir_mxu_kernel")


def log(*a):
    print(*a, flush=True)


def deform_config():
    """``AdaPoinTr-deform``: ``cfgs/PCN_models/AdaPoinTr.yaml`` with its three
    block lists swapped for ``DEFORM_LISTS``, every other value the file's
    (embed 384, k 8, n_group 2, 6 heads, 512 queries, 2048 -> 512 + 16384,
    batch 16). Every deformable token in every call form: each in the
    encoder (shared index), 'deform' and 'deform_graph' in the decoder's
    self half (two-phase search in training), 'rw_deform' there (its own
    search over all tokens in training), 'deform' and 'deform_graph' as
    cross-attention."""
    config = cfg_from_yaml_file(CONFIG)
    enc, dec = config.model.encoder_config, config.model.decoder_config
    enc.block_style_list = list(DEFORM_LISTS["encoder"])
    dec.self_attn_block_style_list = list(DEFORM_LISTS["self"])
    dec.cross_attn_block_style_list = list(DEFORM_LISTS["cross"])
    return config


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


def _tokens(cfg):
    """(encoder, decoder self, decoder cross) local tokens of the model
    config, None for a block without one."""
    enc, dec = cfg.encoder_config, cfg.decoder_config
    return tuple([_parse_style(s)[1] for s in styles] for styles in (
        enc.block_style_list, dec.self_attn_block_style_list, dec.cross_attn_block_style_list))


def _local_calls(token, C, g, n_q, n_v, k, own_knn=False):
    """One local attention block's calls over n_q queries, each with k
    neighbours among n_v values: (knn, gathers whose result feeds only the
    detached shifted positions (the offset features and positions of a
    deformable block: no backward reaches them), gathers whose backward is
    a scatter, fused 3-NN calls). A 3-NN call is (groups, queries, known
    points, channels); its table is the values, so each adds a
    ``weighted_gather_sum_dfeats`` in a backward."""
    S = n_q * k
    knn = [(k, n_q, n_v)] if own_knn else []
    if token == "graph":
        return knn, [], [(n_v, C, S)], []
    offsets = [(n_v, C, S), (n_v, 3, S)]
    if token == "rw_deform":  # and the region's queries
        return knn, offsets, [(n_q, C, S)], [(g, S, n_v, C // g)]
    groups = 1 if token == "deform_graph" else g
    return knn, offsets, [], [(groups, S, n_v, C // groups)]


def _two_phase_calls(token, C, g, nq, L, k):
    """:func:`_local_calls` of a denoise-mode self-attention block ('graph',
    'deform', 'deform_graph'): the real queries search among the nq real
    tokens, the L denoise queries among all Q = nq + L, and each search
    gathers its rows of every table (the values; the offset features and
    positions for a deformable block)."""
    Q = nq + L
    knn = [(k, nq, nq), (k, L, Q)]
    rows = [(nq, C, nq * k), (Q, C, L * k)]
    if token == "graph":
        return knn, [], rows, []
    groups = 1 if token == "deform_graph" else g
    return knn, rows + [(nq, 3, nq * k), (Q, 3, L * k)], [], [(groups, Q * k, Q, C // groups)]


def request_calls(cfg) -> dict:
    """Each kernel's calls in one eval request plus its metrics, per batch
    element count, from the model config: knn (k, S, M), fps (N, npoint),
    gather_rows (M, C, S), nn_bidir_argmin (N, M), weighted_gather_sum
    (S, K, M, C), three_nn_interpolate (groups, S, M, C; the batch times
    the groups is the kernel's). A segmentation model adds one GDANet pass:
    on the ranked queries (the superset) or on the encoder centres
    (SegEncAdaPoinTr)."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd, kg = int(enc.embed_dim), int(enc.k), int(dec.k), 16
    g = int(enc.get("n_group", 2))
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
    interp = []
    enc_t, self_t, cross_t = _tokens(cfg)
    for tokens, n_q, n_v, k in ((enc_t, n2, n2, ke), (self_t, nq, nq, kd), (cross_t, nq, n2, kd)):
        for t in filter(None, tokens):  # every index is given by the stack
            _, offsets, rows, it = _local_calls(t, C, g, n_q, n_v, k)
            gather += offsets + rows
            interp += it
    gather += [(n_fine, 3, n_fine)] * 2  # metric residuals, both directions
    calls = {"knn": knn, "fps": fps, "gather_rows": gather,
             "nn_bidir_argmin": [(n_fine, n_fine)], "weighted_gather_sum": [],
             "three_nn_interpolate": interp}
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
    needs a gradient; weighted_gather_sum_dfeats (groups, S, M, C): the
    backward of every fused 3-NN call. In the decoder's self half a
    'rw_deform' block searches its own neighbours over all Q tokens, the
    others the two-phase way."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd, kg = int(enc.embed_dim), int(enc.k), int(dec.k), 16
    g = int(enc.get("n_group", 2))
    n_cand, L, Q = nq + nq // 2, DENOISE, nq + DENOISE
    factor = n_fine // nq
    N = N_PARTIAL
    knn = [(kg, N, N), (kg, n1, N), (kg, n1, n1), (kg, n2, n1), (ke, n2, n2), (kd, Q, n2)]
    # gathers whose table needs a gradient: their backward is one scatter each
    grad_gathers = [(N, 32, n1), (N, 32, n1 * kg), (n1, 64, n1 * kg), (n1, 64, n2),
                    (n1, 64, n2 * kg), (n_cand, 3, nq)]
    other_gathers, interp = [], []
    enc_t, self_t, cross_t = _tokens(cfg)
    blocks = [_local_calls(t, C, g, n2, n2, ke) for t in enc_t if t]
    blocks += [_local_calls(t, C, g, Q, Q, kd, own_knn=True) if t == "rw_deform"
               else _two_phase_calls(t, C, g, nq, L, kd) for t in self_t if t]
    blocks += [_local_calls(t, C, g, Q, n2, kd) for t in cross_t if t]
    for kn, offsets, rows, it in blocks:
        knn += kn
        other_gathers += offsets
        grad_gathers += rows
        interp += it
    knn += [(factor, L, n_fine)]  # denoise targets
    fps = [(N, n1), (n1, n2), (N, nq // 2), (N, L)]
    chamfer = [(L * factor, L * factor), (nq, n_fine), (n_fine, n_fine)]  # (pred, target)
    gather = [(N, 3, N * kg), (N, 3, n1), (n1, 3, n2),  # grouper coordinates
              (N, 3, nq // 2), (N, 3, L), (n_fine, 3, L * factor)]  # seeds, denoise targets
    gather += grad_gathers + other_gathers
    for n_pred, n_gt in chamfer:  # residuals of both directions
        gather += [(n_gt, 3, n_pred), (n_pred, 3, n_gt)]
    scatter = [(n_pred, 3, n_gt) for n_pred, n_gt in chamfer] + grad_gathers
    return {"knn": knn, "fps": fps, "gather_rows": gather, "nn_bidir_argmin": chamfer,
            "scatter_add_rows": scatter, "nn_one_direction": [], "weighted_gather_sum": [],
            "three_nn_interpolate": interp, "weighted_gather_sum_dfeats": list(interp)}


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


def eval_calls(cfg, protocol: str, mxu: bool = False) -> dict:
    """Each kernel's calls for one cloud of ``validate`` or ``test``: one
    eval request, the coarse cloud's chamfer against the ground truth and,
    in ``test`` at batch size 1, the masked chamfer of the fine cloud (two
    one-direction passes and their residual gathers), the table's F-score
    by one more exact pass, and the auction EMD, whose top-2 launches (one
    per bidding iteration, one more for the greedy fallback) depend on the
    data: ``None``, at least one. With ``mxu``
    (``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER`` set) the eval suite's pass
    over the fine cloud selects by the matmul-form kernel instead of the
    exact one (the same two residual gathers recompute its distances)."""
    nq, n_fine = int(cfg.num_query), int(cfg.num_points)
    calls = {k: list(v) for k, v in request_calls(cfg).items()}
    if mxu:
        calls["nn_bidir_mxu"] = calls["nn_bidir_argmin"]
        calls["nn_bidir_argmin"] = []
    calls["nn_bidir_argmin"].append((nq, n_fine))
    calls["gather_rows"] += [(n_fine, 3, nq), (nq, 3, n_fine)]
    calls.update(scatter_add_rows=[], nn_one_direction=[])
    if protocol == "test":
        calls["nn_one_direction"] = [(n_fine, n_fine)] * 2
        calls["gather_rows"] += [(n_fine, 3, n_fine)] * 4
        calls["nn_bidir_argmin"].append((n_fine, n_fine))
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


def graph_ms(fn, reps: int) -> float:
    """Mean device time in ms of one replay of ``fn`` captured in a CUDA
    graph (the host's launch cost taken out), over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def in_turns(kernel, library, reps=(50, 50)) -> dict:
    """Graph-replay and host-loop times of ``kernel`` and ``library``, each
    taken in turns (kernel, library, library, kernel) on one card: the
    means (kernel, library) of each, and every pair."""
    out = {}
    for how, timer in (("graph", graph_ms), ("loop", cuda_ms)):
        k1 = timer(kernel, reps[0])
        l1, l2 = timer(library, reps[1]), timer(library, reps[1])
        k2 = timer(kernel, reps[0])
        out[how] = ((k1 + k2) / 2, (l1 + l2) / 2)
        out.setdefault("pairs", {})[how] = [k1, l1, l2, k2]
    return out


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


def launch_with_context(kernel: str, entry: str, device: torch.device, *args) -> None:
    """``_build.launch`` as it was before it resolved each C entry once and
    skipped the lock and the device context, for the host-cost comparison
    only: the library lock, a device context, a ``torch.cuda.Stream``
    object and a lookup of the C entry on every call."""
    with _build._lock:
        lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc}")
    _build._launches[kernel] += 1


def host_us(fn, calls: int = 2000) -> float:
    """Mean host time of one ``fn()`` in microseconds: the host clock
    around ``calls`` calls, started after a synchronise (the enqueue, not
    the device's work)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_gather(calls, extra, g, dev):
    inputs = []
    for b, (M, C, S) in batched(calls, extra):
        table = torch.randn(b, M, C, generator=g).to(dev)
        idx = torch.randint(0, M, (b, S), generator=g).to(dev)
        inputs.append((table, idx))
    for M, C, S in ((2048, 3, 4096), (512, 64, 8192), (512, 384, 4096), (777, 5, 3000)):  # clamp probes
        table = torch.randn(B, M, C, generator=g).to(dev)
        idx = torch.randint(-4, M + 4, (B, S), generator=g).to(dev)
        idx[:, :3] = torch.tensor([-1, M, M + 10**6])
        got = ops.gather_rows(table, idx)
        require(torch.equal(got, ops.gather_rows_plain(table, idx)), f"gather clamp C={C}: differs")
        require(torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 2], table[:, M - 1]),
                f"gather clamp C={C}: out-of-range rows not clamped")
        # a contiguous view one float in: no 16-byte words
        flat = torch.randn(B * M * C + 1, generator=g).to(dev)
        view = flat[1:].view(B, M, C)
        require(torch.equal(ops.gather_rows(view, idx), ops.gather_rows_plain(view, idx)),
                f"gather unaligned C={C}: differs")
    err = 0.0
    for table, idx in inputs:
        got = ops.gather_rows(table, idx)
        err = max(err, float((got - ops.gather_rows_plain(table, idx)).abs().max()))
        require(err == 0.0, f"gather {tuple(table.shape)} S={idx.shape[1]}: values differ")
    inputs = inputs[:len(calls)]
    rows = [torch.arange(B, device=dev)[:, None] for _ in inputs]
    kernel = lambda: [ops.gather_rows(tb, i) for tb, i in inputs]  # noqa: E731
    library = lambda: [tb[r, i] for (tb, i), r in zip(inputs, rows)]  # noqa: E731
    turns = in_turns(kernel, library)
    t = {"ms": turns["graph"][0], "plain_ms": cuda_ms(lambda: [ops.gather_rows_plain(tb, i) for tb, i in inputs], 50),
         "library_ms": turns["graph"][1], "loop_ms": turns["loop"][0], "library_loop_ms": turns["loop"][1]}
    # the host's cost of one call: a 1-row gather through the autograd
    # Function and launch_with_context, against the direct route
    table, idx = inputs[0][0][:1].contiguous(), inputs[0][1][:1, :1].contiguous()
    r1 = torch.zeros(1, 1, dtype=torch.int64, device=dev)
    saved = _build.launch
    _build.launch = launch_with_context
    try:
        before = host_us(lambda: pointops._GatherRows.apply(table, idx))
    finally:
        _build.launch = saved
    t["host_us"] = {"function_and_context": before, "direct": host_us(lambda: ops.gather_rows(table, idx)),
                    "indexing": host_us(lambda: table[r1, idx])}
    log(f"phase 2: gather_rows, {len(inputs)} calls of one request, in turns: graph replay "
        f"{turns['graph'][0]:.4f} ms (indexing {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms (indexing {turns['loop'][1]:.4f} ms); each pair "
        f"{json.dumps(turns['pairs'])}; host cost of one 1-row call: {json.dumps(t['host_us'])} us")
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
    # N != M, neither a multiple of a tile, one test cloud's batch
    r1, r2 = sphere(g, 1, 4097, dev), sphere(g, 1, M - 1, dev)
    i1, i2 = ops.nn_bidir_argmin(r1, r2)
    p1, p2 = ops.nn_bidir_argmin_plain(r1, r2)
    require(torch.equal(i1, p1) and torch.equal(i2, p2), "nn_bidir_argmin 4097 x 16383: indices differ")
    require(torch.equal(i1, ops.nn_one_direction(r1, r2)) and torch.equal(i2, ops.nn_one_direction(r2, r1)),
            "nn_bidir_argmin and nn_one_direction select differently")
    # exact ties: every point of each cloud three times over, in another order
    base = torch.randn(2, 3000, 3, generator=g)
    t1 = base.repeat(1, 3, 1)[:, torch.randperm(9000, generator=g)].contiguous().to(dev)
    t2 = base.repeat(1, 3, 1)[:, torch.randperm(9000, generator=g)].contiguous().to(dev)
    i1, i2 = ops.nn_bidir_argmin(t1, t2)
    p1, p2 = ops.nn_bidir_argmin_plain(t1, t2)
    require(torch.equal(i1, p1) and torch.equal(i2, p2), "nn_bidir_argmin ties: indices differ")
    same = torch.randn(2, N, 3, generator=g).to(dev)
    i1, i2 = ops.nn_bidir_argmin(same, same.clone())
    ident = torch.arange(N, device=dev).expand(2, N)
    require(torch.equal(i1, ident) and torch.equal(i2, ident), "identical clouds: argmin is not the identity")
    cd = float(ops.chamfer_l1(same, same.clone()))
    require(cd < 1e-9, f"identical clouds: CD-L1 {cd}")

    def library():  # one distance matrix, its argmin along both axes
        d = torch.cdist(x, y)
        return d.argmin(-1), d.argmin(1)

    turns = in_turns(lambda: ops.nn_bidir_argmin(x, y), library, reps=(10, 3))
    t = {"ms": turns["graph"][0], "plain_ms": cuda_ms(lambda: ops.nn_bidir_argmin_plain(x, y), 1),
         "library_ms": turns["graph"][1], "loop_ms": turns["loop"][0], "library_loop_ms": turns["loop"][1]}
    log(f"phase 2: nn_bidir_argmin at {B}x{N}x{M}, in turns: graph replay {turns['graph'][0]:.4f} ms "
        f"(cdist + argmins {turns['graph'][1]:.4f} ms), host loop {turns['loop'][0]:.4f} ms "
        f"({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
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


def gather_sum_backward_inputs(cases, g, dev, distinct: bool = True) -> list:
    """(w, idx, feats, cotangent) for each (batch, (S, K, M, C)) case, the
    indices distinct per row as a top-k gives them (or, without
    ``distinct``, drawn independently: the 3-NN shapes' rows are too many
    to sort)."""
    out = []
    for b, (S, K, M, C) in cases:
        if distinct:
            idx = torch.rand(b, S, M, generator=g).argsort(dim=-1)[..., :K].contiguous().to(dev)
        else:
            idx = torch.randint(0, M, (b, S, K), generator=g).to(dev)
        w = torch.rand(b, S, K, generator=g).to(dev)
        feats, cot = torch.randn(b, M, C, generator=g).to(dev), torch.randn(b, S, C, generator=g).to(dev)
        out.append((w, idx, feats, cot))
    return out


def check_dfeats(calls, extra, g, dev):
    """weighted_gather_sum_dfeats at K = 3 on the deformable train step's
    3-NN shapes (``calls``: (batch, (S, K, M, C)), timed), where it is the
    interpolation's VJP, and at the superset train step's GDANet shapes and
    the tiny config's (``extra``), held to 1e-5 of each element's sum of
    absolute terms (float32 atomics); out-of-range indices add nothing.
    Library: ``index_add_`` over the materialised (B, S, K, C) terms
    ``w * g``."""
    inputs = gather_sum_backward_inputs(calls, g, dev, distinct=False)
    inputs += gather_sum_backward_inputs(extra, g, dev)
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
    nbytes = sum(b * (S * K * (4 + 8) + S * C * 4 + M * C * 4) for b, (S, K, M, C) in calls)
    return err, t, sum(2 * b * S * K * C for b, (S, K, M, C) in calls), nbytes


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
    for _, idx, feats, cot in (inputs[0], inputs[-1]):
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
    turns = in_turns(lambda: [ops.weighted_gather_sum_dweights(i, c, f) for _, i, f, c in timed],
                     lambda: [torch.bmm(c, f.transpose(1, 2)).gather(2, i) for _, i, f, c in timed])
    t = {"ms": turns["graph"][0],
         "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_dweights_plain(i, c, f) for _, i, f, c in timed], 20),
         "library_ms": turns["graph"][1], "loop_ms": turns["loop"][0], "library_loop_ms": turns["loop"][1]}
    log(f"phase 2: weighted_gather_sum_dweights, {len(timed)} calls at {B_TRAIN} x {calls[0]}, in turns: "
        f"graph replay {turns['graph'][0]:.4f} ms (bmm + gather {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    # idx, g and the table read once, dw written once; a multiply and an add per term
    nbytes = sum(B_TRAIN * (S * K * (8 + 4) + S * C * 4 + M * C * 4) for S, K, M, C in calls)
    return err, t, sum(2 * B_TRAIN * S * K * C for S, K, M, C in calls), nbytes


def check_top2(calls, extra, g, dev):
    """auction_top2 at the test protocol's 16384 x 16384 (one bidding step
    of one cloud), against its plain version: values bit-equal and indices
    equal on the live rows (both compute the value in one order without
    multiply-adds; max is exact, and the kernel's chunk merge is the plain
    version's tile merge), and the same bits in two runs. Probes: live
    counts ``TOP2_LIVE`` (the auction's first iteration, an early one and a
    late one), each as the compacted width the auction hands in and as a
    count over the full width; a batch of 3 with counts (0, 1, N); item
    counts that are not a multiple of the kernel's chunk and below one
    chunk; clouds whose items are duplicated half a cloud apart, so that
    equal values (exact ties at equal prices) fall in different chunks and
    meet in the merge. Timed with every row live (the first iteration's
    work) and at the smallest live width. Library: ``cdist`` squared, minus
    the price, ``topk(2)`` (the matmul form)."""
    from imgadapointr_tpu_torch.ops import emd as port_emd

    (N, M), = calls
    x, y = sphere(g, 1, N, dev), sphere(g, 1, M, dev)
    prices = (torch.zeros(1, M, device=dev), (torch.rand(1, M, generator=g) * 1e-3).to(dev))
    probes = []

    def same(xs, ys, ps, counts, what):
        cnt = torch.tensor(counts, device=dev)
        got, again = ops.auction_top2(xs, ys, ps, cnt), ops.auction_top2(xs, ys, ps, cnt)
        want = ops.auction_top2_plain(xs, ys, ps)
        for b, live in enumerate(counts):
            for a, a2, w in zip(got, again, want):
                require(torch.equal(a[b, :live], w[b, :live]), f"auction_top2 {what}: differs from plain")
                require(torch.equal(a[b, :live], a2[b, :live]), f"auction_top2 {what}: two runs differ")
        probes.append((tuple(xs.shape[:2]), ys.shape[1], counts,
                       port_emd._top2_chunks(xs.shape[0], xs.shape[1], ys.shape[1], dev)))

    for p_i, price in enumerate(prices):
        for live in TOP2_LIVE:
            same(x, y, price, [live], f"{N}x{M} cnt={live} price {p_i}")
            if live < N:
                same(x[:, :live].contiguous(), y, price, [live], f"width {live}x{M} price {p_i}")
    w = TOP2_LIVE[-1]
    same(sphere(g, 3, w, dev), sphere(g, 3, M, dev), (torch.rand(3, M, generator=g) * 1e-3).to(dev),
         [0, 1, w], "B=3 counts (0, 1, N)")
    for m in (M - 5, 100, 20):  # off the chunk; a few chunks; below one chunk
        ys = sphere(g, 1, m, dev)
        same(x[:, :w].contiguous(), ys, (torch.rand(1, m, generator=g) * 1e-3).to(dev), [w], f"M={m}")
    half = y[:, :M // 2]
    dup = torch.cat([half, half], dim=1).contiguous()
    for xs in (x, half[:, :w].contiguous()):  # near ties; exact ties (bidders on the items)
        same(xs, dup, torch.zeros(1, M, device=dev), [xs.shape[1]], f"duplicated items {xs.shape[1]}")
    log("phase 2: auction_top2 probes ((B, width), M, counts, chunks): " + json.dumps(probes))
    price = prices[1]
    full, small = torch.tensor([N], device=dev), torch.tensor([w], device=dev)
    x_small = x[:, :w].contiguous()
    turns = in_turns(lambda: ops.auction_top2(x, y, price, full),
                     lambda: (-(torch.cdist(x, y).square()) - price[:, None, :]).topk(2, dim=-1), reps=(20, 3))
    t = {"ms": turns["graph"][0], "plain_ms": cuda_ms(lambda: ops.auction_top2_plain(x, y, price), 2),
         "library_ms": turns["graph"][1], "loop_ms": turns["loop"][0], "library_loop_ms": turns["loop"][1],
         "live_small": w, "ms_live_small": graph_ms(lambda: ops.auction_top2(x_small, y, price, small), 100),
         "loop_ms_live_small": cuda_ms(lambda: ops.auction_top2(x_small, y, price, small), 100)}
    log(f"phase 2: auction_top2 one launch, in turns: graph replay {t['ms']:.4f} ms at {N} live rows "
        f"(cdist + topk {t['library_ms']:.4f} ms), host loop {t['loop_ms']:.4f} ms; at {w} live rows: "
        f"replay {t['ms_live_small']:.4f} ms ({t['ms_live_small'] / t['ms']:.3f} of the full width), "
        f"loop {t['loop_ms_live_small']:.4f} ms; each pair {json.dumps(turns['pairs'])}")
    # x, y and the prices read once; best, second and the index written once
    return 0.0, t, N * M * OPS_PAIR_TOP2, N * 12 + M * 16 + N * 16


def interp_inputs(cases, g, dev) -> list:
    """(unknown, known, feats) for each (batch, (groups, S, M, C)) case: the
    queries are known points moved by up to 0.05, as shifted neighbour
    positions are."""
    out = []
    for b, (groups, S, M, C) in cases:
        n = b * groups
        known = torch.randn(n, M, 3, generator=g).to(dev)
        pick = torch.randint(0, M, (n, S), generator=g).to(dev)
        shift = ((torch.rand(n, S, 3, generator=g) - 0.5) * 0.1).to(dev)
        out.append((torch.gather(known, 1, pick[..., None].expand(n, S, 3)) + shift, known,
                    torch.randn(n, M, C, generator=g).to(dev)))
    return out


def check_three_nn(calls, extra, g, dev):
    """The fused 3-NN interpolation at every deformable call's shape, one
    serving request's (batch B, timed) and one train step's (B_TRAIN):
    indices equal, weights and outputs bit-equal (the kernel repeats the
    plain version's roundings in its order); probes: queries on known
    points (distance 0), duplicated known points (the lower index first),
    M = 3, C not a multiple of 4. Library: ``cdist().topk(3)``, the weights
    and a gather-weighted sum."""
    inputs = interp_inputs(batched(calls, extra), g, dev)
    known = torch.randn(4, 576, 3, generator=g).to(dev)
    feats = torch.randn(4, 576, 192, generator=g).to(dev)
    probes = [(known[:, :300].contiguous(), known, feats),
              (known[:, :300].contiguous(), torch.cat([known, known], 1), torch.cat([feats, feats], 1)),
              (known, known[:, :3].contiguous(), feats[:, :3, :7].contiguous())]
    for u, k, f in inputs + probes:
        out, idx, w = ops.pointops._three_nn_interpolate_forward(u, k, f, 1e-8)
        pout, pidx, pw = ops.three_nn_interpolate_plain(u, k, f)
        shape = (tuple(u.shape), tuple(k.shape), tuple(f.shape))
        require(torch.equal(idx, pidx), f"three_nn_interpolate {shape}: indices differ")
        require(torch.equal(w, pw) and torch.equal(out, pout), f"three_nn_interpolate {shape}: values differ")
    _, idx, w = ops.pointops._three_nn_interpolate_forward(*probes[1], 1e-8)
    require(bool((idx[..., 0] < 576).all() and (idx[..., 1] == idx[..., 0] + 576).all()
                 and (w[..., 0] > 0.49).all()), "three_nn_interpolate: duplicated points misordered")
    timed = inputs[:len(calls)]

    def library():
        for u, k, f in timed:
            d, i = torch.cdist(u, k).topk(3, dim=-1, largest=False)
            r = torch.reciprocal(d + 1e-8)
            w_ = r / r.sum(-1, keepdim=True)
            rows = torch.gather(f, 1, i.reshape(i.shape[0], -1, 1).expand(-1, -1, f.shape[-1]))
            (w_[..., None] * rows.reshape(*i.shape, f.shape[-1])).sum(2)

    t = {
        "ms": cuda_ms(lambda: [ops.pointops._three_nn_interpolate_forward(u, k, f, 1e-8)
                               for u, k, f in timed], 20),
        "plain_ms": cuda_ms(lambda: [ops.three_nn_interpolate_plain(u, k, f) for u, k, f in timed], 3),
        "library_ms": cuda_ms(library, 10),
    }
    # queries, known points and the table read once; out, idx and w written
    # once; the search ranks every (query, known) pair, the sum 5 operations
    # an output element
    n_ops = sum(B * gr * (S * M * OPS_PAIR_ONE_WAY + S * C * OPS_INTERP_ELEM) for gr, S, M, C in calls)
    nbytes = sum(B * gr * (S * 12 + M * 12 + M * C * 4 + S * C * 4 + S * 3 * (8 + 4))
                 for gr, S, M, C in calls)
    return 0.0, t, n_ops, nbytes


def check_mxu(calls, extra, g, dev):
    """The matmul-form bidirectional argmin at the eval suite's 16384 x
    16384 at batch B (timed) and a ragged shape, random and on a dense
    sphere: indices equal to the plain version's. Library: ``cdist`` with
    ``use_mm_for_euclid_dist``, then argmin along both axes."""
    for b, (N, M) in batched(calls, extra):
        for kind in ("random", "sphere"):
            if kind == "random":
                x, y = torch.randn(b, N, 3, generator=g).to(dev), torch.randn(b, M, 3, generator=g).to(dev)
            else:
                x, y = sphere(g, b, N, dev), sphere(g, b, M, dev)
            i1, i2 = ops.nn_argmin_bidir_mxu(x, y)
            p1, p2 = ops.nn_argmin_bidir_mxu_plain(x, y)
            require(torch.equal(i1, p1) and torch.equal(i2, p2),
                    f"nn_bidir_mxu {kind} {b}x{N}x{M}: indices differ from plain")
    (N, M), = calls
    x, y = sphere(g, B, N, dev), sphere(g, B, M, dev)

    def library():
        d = torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")
        return d.argmin(-1), d.argmin(1)

    t = {
        "ms": cuda_ms(lambda: ops.nn_argmin_bidir_mxu(x, y), 10),
        "plain_ms": cuda_ms(lambda: ops.nn_argmin_bidir_mxu_plain(x, y), 1),
        "library_ms": cuda_ms(library, 5),
    }
    n_ops = {PEAK_BF16_TC: B * N * M * OPS_PAIR_MXU_TC, PEAK_F32: B * N * M * OPS_PAIR_MXU_F32}
    return 0.0, t, n_ops, B * (N + M) * 12 + B * (N + M) * 8


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


def run_train_steps(runner, batches, calls, what: str, phase: str):
    """1 warm-up and ``TRAIN_STEPS`` timed steps of ``runner`` on
    ``batches`` (the loader's, in order), their losses finite and their
    launches the table ``calls``; returns (launch counts, step seconds,
    peak bytes allocated)."""
    secs, _ = timed_step(runner, batches[0], 0.0)  # warm-up (cuBLAS handles, caches)
    log(f"{phase}: warm-up step {secs * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for i, batch in enumerate(batches[1:1 + TRAIN_STEPS]):
        secs, m = timed_step(runner, batch, (i + 1) / len(batches))
        times.append(secs)
        require(all(np.isfinite(v) for v in m.values()), f"{phase} step {i}: non-finite {m}")
        log(f"{phase}: step {i}: {secs * 1e3:.1f} ms; sparse {m['sparse_loss']:.5f} dense "
            f"{m['dense_loss']:.5f} grad norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")
    counts = check_launches(what, calls, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    log(f"{phase}: median step {statistics.median(times) * 1e3:.1f} ms at batch {B_TRAIN}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps({k: v // TRAIN_STEPS for k, v in counts.items()})}")
    return counts, times, peak


def check_trained(model, before: dict, dead=("query_ranking", "encoder.norm"), frozen=()) -> None:
    """After the steps: a frozen parameter (``frozen``) and one that gets no
    gradient by construction (``dead``) has no gradient and its initial
    value; every other parameter moved."""
    for name, p in model.named_parameters():
        if any(f in name for f in frozen):
            require(not p.requires_grad and p.grad is None and torch.equal(p, before[name]),
                    f"{name}: the frozen parameter was touched")
        elif any(d in name for d in dead):
            require(p.grad is None and torch.equal(p, before[name]), f"{name} was touched")
        else:
            require(not torch.equal(p, before[name]), f"{name} did not change in {TRAIN_STEPS + 1} steps")


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

    train, times, peak = run_train_steps(runner, batches, calls, "the train steps", "phase 4")
    counts = {"train": train}
    check_trained(model, before)
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
    mxu_counts, mxu = mxu_eval_check(runner, val_loader, test_loader, args, config, metrics, scores)
    counts.update(mxu_counts)
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
               "emd": {k: emd[k] for k in ("emd_ms", "top2_launches", "iterations", "converged",
                                           "top2_in_path_ms", "device_busy_ms")},
               "mxu_eval": mxu}
    return counts, summary


def mxu_eval_check(runner, val_loader, test_loader, args, config, exact_val, exact_test):
    """``validate`` and ``test`` again with ``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER``
    set for these two calls only: the eval suite's pass over each fine
    cloud selects by the matmul-form kernel, whose launches must replace
    the exact kernel's as ``eval_calls(..., mxu=True)`` says; CD-L1 and CD-L2
    x1000 within 1e-3 of the exact run's, and the test table (its CDs from
    the masked exact path, its F-score recomputed exactly) equal to the
    exact run's; then one test step without EMD, profiled. Returns the
    launch counts and the readings."""
    cfg = config.model
    prev = os.environ.get(MXU_FLAG)
    os.environ[MXU_FLAG] = "1"
    try:
        _build.reset_launches()
        val = port_runner.validate(runner, val_loader, 0, "silent")
        counts = {"validate_mxu": check_launches("validate under the flag",
                                                 eval_calls(cfg, "validate", mxu=True), EVAL_CLOUDS)}
        _build.reset_launches()
        test = port_runner.test(runner, test_loader, args, config, "silent")
        counts["test_mxu"] = check_launches("test under the flag", eval_calls(cfg, "test", mxu=True),
                                            EVAL_CLOUDS)
        batch = next(iter(test_loader))[2]

        def one_cloud():  # the test step without EMD: its masked and matmul-form passes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.test_step(batch, require_emd=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        prof = profile_run(one_cloud)
    finally:
        if prev is None:
            os.environ.pop(MXU_FLAG, None)
        else:
            os.environ[MXU_FLAG] = prev
    v, e = val.state_dict(), exact_val.state_dict()
    out = {"validate": v, "validate_exact": e,
           "cd_l1_delta_x1000": abs(v["CDL1"] - e["CDL1"]), "cd_l2_delta_x1000": abs(v["CDL2"] - e["CDL2"]),
           "test": {k: float(x) for k, x in test.items()},
           "launches_per_cloud": {k: {n: c[n] // EVAL_CLOUDS for n in ("nn_bidir_argmin", "nn_bidir_mxu")}
                                  for k, c in counts.items()},
           "profiled_test_cloud": {k: v for k, v in prof.items() if k != "top"}}
    log("phase 4: validate and test under the matmul-form eval chamfer: " + json.dumps(out))
    require(out["cd_l1_delta_x1000"] <= 1e-3 and out["cd_l2_delta_x1000"] <= 1e-3,
            "the matmul-form eval chamfer moved a CD x1000 by more than 1e-3")
    for k in ("F-Score", "CDL1", "CDL2"):
        require(float(test[k]) == float(exact_test[k]), f"test under the flag: {k} differs from the exact run")
    return counts, out


def emd_check(runner, batch, dev) -> dict:
    """The auction EMD of one test cloud (the model's fine cloud against
    the 16384-point ground truth): its time (host clock between
    synchronises, three runs), the active bidders of every iteration, the
    top-2 launches, and the assignment through the kernel against the same
    loop through the plain top-2 on the card; then one profiled run, with
    the top-2's device time in it."""
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
            # device time of the top-2's kernels in the profiled auction, and its device busy
            "top2_in_path_ms": prof.get("ported_kernels_ms", {}).get("auction_top2"),
            "device_busy_ms": prof.get("device_busy_ms"),
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

    train, times, peak = run_train_steps(runner, batches, superset_train_calls(cfg),
                                         "the superset's train steps", "phase 6")
    counts = {"superset_train": train}
    check_trained(model, before, frozen=("segmentator",))
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


# ------------------------------------------------------------ phase 7 path


def deform_phase(seed: int, dev, card: str, workdir: str):
    """Phase 7: ``AdaPoinTr-deform`` (:func:`deform_config`) at full width
    with seeded weights: ``REQUESTS`` requests of ``B`` with metrics and
    their launch table (8 fused 3-NN calls a request), a profiled request,
    one request at batch 2 against the CPU; then 1 warm-up and
    ``TRAIN_STEPS`` steps of ``Runner.train_step`` at ``B_TRAIN`` with their
    table (8 fused 3-NN calls and 8 of their VJP, ``dfeats``), the offset
    nets and ``proj_v_off`` untouched and every other trainable parameter
    moved, a profiled step and the peak memory, and one step at batch 2
    against the CPU. Returns the launch counts and the summary."""
    config = deform_config()
    cfg = config.model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 7: AdaPoinTr-deform built on {dev}, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    batches = make_requests(cfg, seed, REQUESTS + 1)
    serve(model, cfg, batches[:1], dev)  # warm-up request
    _build.reset_launches()
    secs, scores = serve(model, cfg, batches[1:], dev)
    calls = dict(request_calls(cfg), scatter_add_rows=[], nn_one_direction=[])
    counts = {"deform_request": check_launches("the deformable requests", calls, REQUESTS)}
    for r, (sec, (f, l1, l2)) in enumerate(zip(secs, scores)):
        log(f"phase 7: request {r}: {B}x{N_PARTIAL} -> {B}x{int(cfg.num_points)} in {sec * 1e3:.1f} ms; "
            f"CD-L1 {l1:.4f} CD-L2 {l2:.4f} F@0.01 {f:.4f}")
    log(f"phase 7: median deformable request {statistics.median(secs) * 1e3:.1f} ms on {card}; launches "
        f"per request {json.dumps({k: v // REQUESTS for k, v in counts['deform_request'].items()})}")
    prof = profile_run(lambda: serve(model, cfg, [batches[1]], dev)[0][0])
    log("phase 7: one profiled deformable request: " + json.dumps(prof))
    # batch 2 against the CPU, the last ranking layer scaled on both (as in phase 5)
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    for m in (model, cpu_model):
        with torch.no_grad():
            m.base_model.query_ranking[4].weight.mul_(1000.0)
    agree = cpu_agreement(model, cpu_model, {k: v[:2] for k, v in batches[1].items()}, dev)
    log("phase 7: card vs CPU at batch 2: " + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "AdaPoinTr-deform: the card's clouds disagree with the CPU's")
    require(abs(agree["cd_l1_card"] - agree["cd_l1_cpu"]) <= 1e-2 * agree["cd_l1_cpu"],
            "AdaPoinTr-deform: the card's CD-L1 disagrees with the CPU's")
    del model, cpu_model

    swap_synthetic(config, train_len=B_TRAIN * (TRAIN_STEPS + 2))
    config.dataset.train.others.bs = B_TRAIN
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    batches = [b for _, _, b in train_loader]
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    train, times, peak = run_train_steps(runner, batches, train_step_calls(cfg),
                                         "the deformable train steps", "phase 7")
    counts["deform_train"] = train
    check_trained(runner.model, before, dead=("query_ranking", "encoder.norm", "linear_offset", "proj_v_off"))
    step_prof = profile_run(lambda: timed_step(runner, batches[1 + TRAIN_STEPS], 0.9)[0])
    log("phase 7: one profiled deformable train step: " + json.dumps(step_prof))
    del runner, batches
    torch.cuda.empty_cache()
    step_agree = card_vs_cpu_step(deform_config(), seed, workdir)
    log("phase 7: card vs CPU, one deformable step at batch 2: " + json.dumps(step_agree))
    summary = {"request_batch": B, "request_ms": [t * 1e3 for t in secs],
               "median_request_ms": statistics.median(secs) * 1e3,
               "profiled_request": {k: v for k, v in prof.items() if k != "top"},
               "card_vs_cpu_request": {k: agree[k] for k in ("coarse_matched", "fine_matched",
                                                             "coarse_hausdorff", "fine_hausdorff")},
               "train_batch": B_TRAIN, "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in step_prof.items() if k != "top"},
               "card_vs_cpu_step": {k: step_agree[k] for k in ("total_loss_rel_diff", "grad_norm_rel_diff")}}
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
    check_calls.update(weighted_gather_sum_dweights=bwd, auction_top2=[(n_fine, n_fine)])
    extra.update(weighted_gather_sum_dweights=bwd_extra)
    # the deformable model's fused 3-NN calls: one request's at B (timed) and
    # one train step's at B_TRAIN; their VJP, dfeats at K = 3, at the step's
    # (timed), then at the gather-sum's GDANet shapes; the matmul-form argmin
    # at the eval suite's 16384 x 16384 and a ragged shape
    dcfg = deform_config().model
    d_train = train_step_calls(dcfg)
    check_calls.update(three_nn_interpolate=request_calls(dcfg)["three_nn_interpolate"],
                       nn_bidir_mxu=[(n_fine, n_fine)],
                       weighted_gather_sum_dfeats=[(B_TRAIN * gr, (S, 3, M, C))
                                                   for gr, S, M, C in d_train["weighted_gather_sum_dfeats"]])
    extra.update(three_nn_interpolate=[(B_TRAIN, c) for c in d_train["three_nn_interpolate"]],
                 nn_bidir_mxu=[(2, (4097, n_fine - 1))],
                 weighted_gather_sum_dfeats=[(B_TRAIN, c) for c in bwd] + bwd_extra)
    g = torch.Generator().manual_seed(args.seed)
    checks = {"knn": check_knn, "fps": check_fps, "gather_rows": check_gather,
              "nn_bidir_argmin": check_bidir, "scatter_add_rows": check_scatter,
              "nn_one_direction": check_one_direction,
              "weighted_gather_sum": check_weighted_gather_sum,
              "weighted_gather_sum_dfeats": check_dfeats, "weighted_gather_sum_dweights": check_dweights,
              "auction_top2": check_top2, "three_nn_interpolate": check_three_nn, "nn_bidir_mxu": check_mxu}
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

    # ---- phase 7: AdaPoinTr with deformable local attention at full width
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        deform_counts, deform_summary = deform_phase(args.seed, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    counts.update(deform_counts)

    kernels = []
    for name in _build.KERNELS:
        err, t, n_ops, nbytes = results[name]
        # a count of float32 operations, or counts by the peak rate of their type
        by_rate = n_ops if isinstance(n_ops, dict) else {PEAK_F32: n_ops}
        op_ms = sum(n / rate for rate, n in by_rate.items()) * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # over every driven path; each path's counts were read on their own
            "launches": launches[name] + sum(c[name] for c in counts.values()),
            "launches_per_request": launches[name] // REQUESTS,
            "launches_per_superset_request": counts["ImgEncSegDecAdaPoinTrVariableLoss"][name] // REQUESTS,
            "launches_per_train_step": counts["train"][name] // TRAIN_STEPS,
            "launches_per_superset_train_step": counts["superset_train"][name] // TRAIN_STEPS,
            "launches_per_deform_request": counts["deform_request"][name] // REQUESTS,
            "launches_per_deform_train_step": counts["deform_train"][name] // TRAIN_STEPS,
            "launches_validate": counts["validate"][name], "launches_test": counts["test"][name],
            "launches_validate_mxu": counts["validate_mxu"][name],
            "launches_test_mxu": counts["test_mxu"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": t["library_ms"],
            # the kernels timed by graph replay: their host-loop times too
            **{k: t[k] for k in ("loop_ms", "library_loop_ms", "host_us", "ms_live_small",
                                 "loop_ms_live_small", "live_small") if k in t},
        })
        if name in NOT_ON_A_PATH:
            require(kernels[-1]["launches"] == 0, f"{name}: launched on a path the tables say it is not on")
            kernels[-1]["not_on_a_path"] = NOT_ON_A_PATH[name]
    # the paths' readings again, so that the end of the output carries them
    log("summary: " + json.dumps({"card": card, "serving": serve_summary, "training": train_summary,
                                  "card_vs_cpu_step": {k: agree[k] for k in (
                                      "total_loss_rel_diff", "grad_norm_rel_diff")},
                                  "superset_serving": superset_summary,
                                  "superset_training": superset_train_summary,
                                  "deform": deform_summary}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
