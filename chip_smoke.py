#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero and prints no result line:

1. checks: a CUDA device, the card's name and power limit (nvidia-smi), the
   build of every kernel in ``imgadapointr_tpu_torch/csrc``, and ``HMMA``
   instructions in the matmul-form argmin's SASS (``cuobjdump -sass``);
2. every kernel against its plain PyTorch version on the card, at each
   shape one serving request (batch ``B``), one train step (batch
   ``B_TRAIN``) and one request of the segmentation models (batch ``B``)
   give it (the one-direction argmin: one test cloud), plus edge probes
   (identical clouds, dense sphere, all-equal points, out-of-range
   indices, masks).
   Indices must be equal and values bit-equal (tolerance 0): each kernel
   repeats its plain version's arithmetic. The scatter-add and the
   gather-sum's ``dfeats`` sum each element in source order, so they are
   held to the plain version run on the CPU, bit for bit, and two launches
   to each other; the weighted gather-sum
   sums in another order than its plain version and is held to 1e-5 of each
   element's sum of absolute terms, and two launches to each other's bits;
   the matmul-form argmin sums on the
   tensor cores in their own order and is held to its plain version by a
   band (``mxu_band``), and to equal indices on lattice clouds, where every
   sum is exact. Each kernel, its plain version
   and, where one PyTorch call computes the same function, that call are
   timed with CUDA events over one serving request's calls (the
   scatter-add: one train step's; the one-direction argmin: one test
   cloud's; the weighted gather-sum: one superset request's). The row
   gather, the bidirectional argmin, the weighted gather-sum and its
   ``dweights``, the auction top-2, kNN, FPS, the one-direction argmin,
   ``dfeats`` and the grouped 3-NN interpolation are also timed with the
   host taken out, by
   replaying their calls and their library call captured in a CUDA graph,
   in turns with the host loop on the same card; their ``ms`` and
   ``library_ms`` are the replay times (the top-2 also at its smallest
   live width; kNN also over one flagship train step's calls at
   ``B_TRAIN``, its denoise-target call alone and the normals' call; the
   phase-2 log gives kNN an estimated issue-slot floor and FPS an estimated
   latency floor, which stay out of the ``kernels`` line, since neither is
   measured), and the gather prints the host
   cost of one 1-row call on its direct route and on the route through
   the autograd Function and ``launch_with_context`` (the launch path as it
   was before it resolved entries once and skipped the lock and the
   device context); the scatter-add, the matmul-form argmin, the
   one-direction argmin, ``dfeats`` and the weighted gather-sum are timed by
   ``time_scatter``, ``time_mxu``, ``time_one_direction``, ``time_dfeats``
   and ``time_gather_sum``, and the
   deformable gather around the 3-NN (``grouped_deform_gather``, forward
   and forward with backward) by ``time_grouped_gather`` (public ops and
   unchanged signatures only, so they time an older tree too), the
   matmul-form beside the exact kernel's replay time;
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
   read back bit-equal, one step's gradients taken twice from the same
   state are compared (``step_determinism``: the chamfer loss's gradient
   with respect to the predicted clouds must be bit-equal; every
   parameter's is read), and one step at batch 2 must agree with the same
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
   norm ``SUPERSET_GRAD_NORM_TOL``, GDANet's differing selections counted
   and read in the CPU's scores, position by position and after matching
   GDANet's input points of the two devices: ``pick_gaps``);
7. ``AdaPoinTr-deform`` (:func:`deform_config`: the flagship with
   deformable local attention, every token in every call form) at full
   width: ``REQUESTS`` requests of ``B`` with metrics and their launch table
   (8 fused 3-NN interpolations a request), a profiled request, one request
   at batch 2 against the CPU (clouds as sets); 1 warm-up and
   ``TRAIN_STEPS`` steps of ``Runner.train_step`` at batch 16 with their
   table (8 fused 3-NN calls and 8 of their VJP, ``dfeats``), the offset
   nets and ``proj_v_off`` without gradient and untouched, every other
   trainable parameter moved, a profiled step, one step's gradients twice
   from the same state (``step_determinism``: every parameter's gradient
   must be bit-equal), and one step at batch 2 against the CPU (loss 1e-4,
   gradient norm 1e-3, relative);
8. the recipes from trees on disk, written with the port's ``IO.put`` into
   a temporary directory in the layouts the dataset configs name (numpy
   only), read by the port's readers and loader, at full width:
   - PCN (``cfgs/PCN_models/AdaPoinTr.yaml``: binary ``.pcd``, 16384-point
     complete clouds, partials of 1400-2700 points, 8 renders): the
     loader's batches with 2 worker processes equal to the reader's made
     in this process in the JAX loader's order, and the workers stopped;
     1 warm-up and ``TRAIN_STEPS`` steps at batch 16 with the flagship's
     launch table, a profiled step; ``validate`` and ``test`` (EMD) on 2
     clouds at batch 1 and at ``--val_bs`` ``B_VAL``, with their tables,
     every metric but EMD equal across the two batch sizes to 1e-5; the
     auction EMD on the same dense clouds at batch ``B_VAL`` and one cloud
     at a time (``emd_batch_check``: assignments equal), beside the EMD of
     each cloud's own batch-1 forward; one checkpoint save timed
     (``--save_freq``'s cost);
   - ShapeNet-55 (``cfgs/ShapeNet55_models/AdaPoinTr.yaml``: 8192-point
     ``.npy`` clouds): 1 warm-up and ``TRAIN_STEPS`` steps at total_bs 64
     with the train crop (the table adds its FPS, 64 x 8192 -> 2048, and
     its two gathers), a profiled step, the crop profiled alone (its FPS's
     in-path time); the 8-viewpoint test on 2 clouds at ``B_VAL`` in
     ``easy``, ``median`` and ``hard`` with their tables; one crop of 2
     clouds, its FPS and the forward against the CPU through the plain
     versions (centres, orders, kept clouds and picks equal; clouds as sets
     and CD-L1 within phase 3's band);
   - the KITTI finetune (``cfgs/KITTI_models/AdaPoinTr.yaml``: PCN cars, the
     ``CARS`` filter): 1 warm-up and ``TRAIN_STEPS`` steps at batch 16 with
     the train dropping (the table adds its FPS, 16 x 2048 -> 768, and its
     gather), a profiled step. The KITTI test protocol draws its images
     with matplotlib, which the card's machine lacks, so it is not driven
     here (``tests/test_torch_recipes.py`` drives it on the CPU).
   Each recipe prints its median step (host clock), one profiled step's
   device busy and launches, the peak memory and the loader's host time a
   batch;
9. the five PCN baselines at the full width of their shipped configs
   (``cfgs/PCN_models/{FoldingNet,PCN,TopNet,SnowFlakeNet,GRNet}.yaml``,
   seeded weights), each on a PCN tree written as in phase 8 (SnowFlakeNet
   reads it through ``PCNv2``): ``REQUESTS`` requests of ``B`` (2048 ->
   its dense cloud) with their launch table (:func:`baseline_calls`) and a
   profiled one; 1 warm-up and ``BASELINE_STEPS`` steps of
   ``Runner.train_step`` at the config's ``total_bs`` (32 or 64) with the
   table, every parameter moved, the peak memory and a profiled step;
   ``validate`` and ``test`` (EMD) on 2 clouds at batch 1 with their
   tables; one step at batch 2 against the CPU through the plain versions
   (loss 1e-4, gradient norm 1e-3, relative). SnowFlakeNet's and GRNet's
   step gradients are taken twice from the same state and every
   parameter's must be bit-equal (GRNet's 3-D convolutions on cuDNN's
   deterministic algorithms, which the runner's train step asks for:
   ``utils/device.py:deterministic_cudnn``). GRNet also serves and steps
   once more each way round: requests on the deterministic algorithms, and
   steps and the two-run gradients on cuDNN's default ones (read, not
   required equal), so that the flag's price and its need show in one run
   (:func:`without_deterministic_cudnn`). GRNet's point
   ops (the gridding's scatter, the cubic sampling's gather and its
   scatter) are also held to the same bits twice and to the CPU's
   (:func:`check_gridding`). Then
   ``AdaPoinTr-tiny-k2.yaml`` (``step_per_update: 2``) takes 4 train steps:
   the optimizer must step on the 2nd and 4th only.

Phase 2 also holds FPS at the recipes' shapes (the ShapeNet-55 train
crop's 64 x 8192 -> 2048 on crop clouds whose cropped rows are copies of
the farthest point, up to 6144 of them; the test crops' 16 x 6144 | 4096 |
2048 -> 2048; the KITTI dropping's 16 x 2048 -> 768 on zero-padded
partials), the gather at the crops' shapes and the bidirectional argmin at
64 x 8192 x 8192, and times the crop's FPS call by graph replay beside the
request's (``crop_*`` in the ``kernels`` line). It holds kNN, FPS, the
gather, the bidirectional argmin and the scatter-add at every shape of
the recipes' model calls too: the ShapeNet-55 train step at batch 64 (its
denoise search of 64 queries against 8192 points among them), its test
batch's eval calls at 8 viewpoints x ``B_VAL``, and the PCN validate and
test at batch 1 and ``B_VAL`` (kNN's chunk count, among others, depends on
the batch).
Phase 2 holds kNN at every request, step, normals and deformable shape
and at probes (M below 32, M off the tile and the chunk, one query, k =
64, points duplicated half a cloud apart on the split route so that ties
meet in the merge, fewer distinct distances than k), and FPS at every
shape and at probes (14511 and 16384 points, one point, one pick, more
picks than points, identical points at widths off the block's, a cloud
past the limit), both the same bits in two runs.
Phase 2 also holds the gather-sum's two backward kernels (``dfeats`` at
K = 3 on the deformable train step's 3-NN shapes, where it is the
interpolation's VJP, and both at the superset train step's GDANet shapes
and the tiny config's; ``dfeats`` bit-equal to the CPU plain version and
the same bits in two runs, also with two in three indices out of range,
every term in one row and a row that no term reaches; ``dweights`` 1e-5 of
each element's absolute sum, the same bits in two runs), the one-direction
argmin at the probes of its candidate chunks (points duplicated half a
cloud apart, a batch element with no valid candidate, N = 1, M = 1, M off
the chunk, rows that fill the card alone), the auction top-2
(16384 x 16384 at 16384, about 3500 and about 1060 live rows, a batch of 3
with counts (0, 1, N), item counts off the kernel's chunk and below one
chunk, duplicated items whose ties meet in the chunk merge; values
bit-equal, indices equal, the same bits in two runs), the fused 3-NN interpolation (grouped, at every
deformable call's shape at serving and train batch, and the ungrouped op's
probes; indices equal, values bit-equal; at the train batch the gradient in
v bit-equal to the old composition's, and ``dfeats`` reading the cotangent
by groups in place bit-equal to ``dfeats`` on contiguous copies) and the matmul-form argmin of the opt-in eval chamfer (8 x 16384
x 16384 and a ragged shape: the band on random clouds and a dense sphere,
indices equal on lattices, identical and duplicated clouds) against their
plain versions. The scatter-add is held, bit for bit, at every shape of the
flagship, superset and deformable train steps and at probes (mirror
directions, permutations, 16384 sources in one row, clamped indices,
mostly empty rows, more than 16384 rows or sources).
Phase 4's test protocol runs the auction EMD at 16384 x 16384 on each
cloud: its time per cloud, iterations, top-2 launches, the top-2's device
time in one profiled auction, and one cloud's assignment through the
kernel equal to the plain path's (and to a second run's). Phase 4 then runs
``validate`` and ``test`` again with ``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER``
set for those calls only: the matmul-form kernel's launches replace the
exact kernel's in the eval suite, CD-L1 and CD-L2 x1000 stay within 1e-3 of
the exact run's, and the test table (exact F-score) is the exact run's.

Phase 2 also holds every kernel on the baselines' paths at their train
steps' shapes (``baseline_calls``): the bidirectional argmin at 32 and 64 x
16384 x 16384 and the smaller loss pairs, FPS at 64 x {2048 -> 512, 512 ->
128, 2304 -> 512, 16384 -> 2048, 2048 -> 512, 512 -> 256} (16384 points:
the ``<16, 1024>`` route, timed by graph replay beside its bound), kNN (k =
16) over 128, 512 and 2048 points at 64, the gather and the scatter-add at
SnowFlakeNet's widths (C 3, 64, 128) and at GRNet's volumes (32³ x 32, 16³
x 64, 8³ x 128, the 2048 + 64³ sampled rows) and the gridding's scatter
at C = 1 into 64³ rows.

10. the entry points on the card (:func:`entry_points_phase`), at full
   width:
   a. the serving CLI (``tools/inference.py``) on
      ``cfgs/PCN_models/AdaPoinTr.yaml`` with seeded weights saved as
      ``.pth``, over a ``--pc_root`` holding one synthetic partial cloud as
      ``.npy``, ``.pcd``, ``.ply`` and ``.txt`` (and ``.h5`` where ``h5py``
      imports): every ``fine.npy`` bit-equal to the model's own forward on
      the upsampled cloud (``.txt`` within ``TXT_ATOL``; ``np.savetxt``
      writes 19 digits), the launches those of a request at batch 1 without
      the metrics, per file; then ``PCReconstructor`` on the same ``.pth``,
      one request, its table the same;
   b. ``PCReconstructor`` on the superset
      (``ImgEncSegDecAdaPoinTrVariableLoss``, seeded weights saved as
      ``.pth``): a ``.pcd`` cloud, a ``.png`` image (where PIL imports; else
      ``forward`` on the decoded image array, the same device path) and a
      class id, 1 warm-up and ``REQUESTS`` requests, each bit-equal to the
      model's own forward on the same inputs, with the superset's request
      table at batch 1 without the metrics; the median ms;
   c. ``main --synthetic --profile`` on the flagship at batch 16 for one
      epoch of ``PROFILE_STEPS`` steps (the config's ``max_epoch`` cut to 1
      in a copy) and its validation: a ``torch.profiler`` trace under the
      run's ``tfboard_path`` whose CUDA kernel events hold every ported
      kernel of the flagship step (names and counts printed), and the
      launches of 7 steps and 16 validated clouds;
   d. ``--worker_mode``: the ShapeNet-55 loader at batch 64 over a tree
      of 6 batches with 0 workers and with 8 threads and 8 processes: an
      epoch's batches bit-equal across the three, the host ms a batch of
      each, and the recipe's train step fed by each beside the same steps
      on batches in memory (``PERF.md`` §7's question);
   e. the TensorBoard writers: where ``tensorboardX`` or ``tensorboard``
      imports, (c)'s event files in ``train/`` and ``test/``; else one line
      that they are off, as in the JAX package.

11. the options no shipped config sets (:func:`options_phase`), at full
   width:
   a. the options flagship (:func:`options_config`: the flagship's widths
      with the ``pn`` encoder, the ``fold`` head, 'onebyone' in the
      encoder and both decoder halves, LayerScale at 1e-5 and dropout,
      attention dropout and DropPath at ``OPTION_RATE``; 2048 -> 512 +
      32768 points): 1 warm-up and ``REQUESTS`` requests of ``B`` with
      their launch table, the peak memory and a profiled request; batch 2
      against the CPU (clouds equal as sets, share within 1e-4 >= 0.99);
      1 warm-up and ``TRAIN_STEPS`` steps of ``Runner.train_step`` at
      ``B_TRAIN`` with their table, every trainable parameter moved, a
      profiled step; the gradients of one step twice from one state,
      masks and all, bit-equal (:func:`step_determinism`); every mask of
      one step within a 6-sigma binomial band of its keep share
      (:func:`kept_shares`); ``validate`` on ``EVAL_CLOUDS`` clouds (32768
      against 16384 points) with its table; one step at batch 2 with the
      rates at 0 against the CPU (loss 1e-4 relative, gradient norm 1e-3);
   b. :func:`options_deform_config` (``AdaPoinTr-deform`` with 'onebyone',
      LayerScale and DropPath at 0.1): 1 + ``TRAIN_STEPS`` steps at
      ``B_TRAIN`` with their table (the grouped 3-NN and ``dfeats`` under
      the two-branch blocks), every parameter's gradient bit-equal twice;
   c. the standalone modules at dim 384, 6 heads, batch ``B``
      (:func:`modules_phase`): the seven legacy blocks (LayerScale at 1) on
      ``LEGACY_TOKENS`` tokens, the decoder blocks over ``LEGACY_MEMORY``,
      and ``ImprovedDeformableLocalCrossAttention`` (k 8, n_group 2) on the
      decoder's cross shapes, forward and backward against the CPU (the
      loss ``sum(sin(out))`` within 1e-4 relative, the gradients within
      1e-3 of their norm); ResNet50 and ConvNeXt-small at ``B`` x 224²
      against the CPU, TF32 off, within ``IMAGE_BAND`` of the output's
      largest magnitude; ``ball_query`` on lattice clouds (coordinates
      k/64, every product and sum exact) index-equal to the CPU's;
   d. one superset forward and backward at ``B_TRAIN`` without and with
      ``IMGADAPOINTR_ENABLE_SEG_REMAT`` (:func:`remat_check`): the loss
      bit-equal, every gradient within 1e-6 of its largest entry, and the
      device busy time and peak memory of each.
   Phase 2 also holds kNN, FPS, the gather, the bidirectional argmin and
   the scatter-add at the options flagship's request (``B``) and step
   (``B_TRAIN``) shapes: the ``pn`` grouper's FPS 2048 -> 256 and k = 32
   search, the denoise targets at k = 64, the argmin at 32768 x 16384.

Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
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
from imgadapointr_tpu_torch.datasets.loader import base_seed
from imgadapointr_tpu_torch.datasets.synthetic import _surface_points
from imgadapointr_tpu_torch.demo import PCReconstructor
from imgadapointr_tpu_torch.main import main as port_main
from imgadapointr_tpu_torch.main import swap_synthetic
from imgadapointr_tpu_torch.models import BASELINES, build_model
from imgadapointr_tpu_torch.models.adapointr import rebuild_factor
from imgadapointr_tpu_torch.models import gdanet as port_gdanet
from imgadapointr_tpu_torch.nn import image_encoders as port_image
from imgadapointr_tpu_torch.nn import layers as port_layers
from imgadapointr_tpu_torch.nn import legacy_blocks as port_legacy
from imgadapointr_tpu_torch.nn import local_attention as port_la
from imgadapointr_tpu_torch.nn.blocks import _parse_style
from imgadapointr_tpu_torch.nn.layers import init_weights_
from imgadapointr_tpu_torch.ops import _build, chamfer, pointops, sampling
from imgadapointr_tpu_torch.ops import emd as port_emd
from imgadapointr_tpu_torch.ops import gridding as port_gridding
from imgadapointr_tpu_torch.tools import inference as port_inference
from imgadapointr_tpu_torch.tools import runner as port_runner
from imgadapointr_tpu_torch.tools.builder import dataset_builder
from imgadapointr_tpu_torch.utils.checkpoint import load_checkpoint
from imgadapointr_tpu_torch.utils.config import cfg_from_yaml_file
from imgadapointr_tpu_torch.utils.device import deterministic_cudnn
from imgadapointr_tpu_torch.utils.io_module import IO
from imgadapointr_tpu_torch.utils.metrics import compute_metrics_per_sample, eval_metric_suite

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
# the recipes of phase 8: ShapeNet-55 (8192-point clouds, total_bs 64, the
# train crop) and the KITTI finetune (PCN cars, the train dropping)
SHAPENET = "cfgs/ShapeNet55_models/AdaPoinTr.yaml"
KITTI = "cfgs/KITTI_models/AdaPoinTr.yaml"
B_SHAPENET = 64
N_SHAPENET = 8192
B_VAL = 2  # phase 8's --val_bs
DROP_POINTS = 768  # the dropping's FPS prefix (ops/sampling.py:random_dropping)
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
# Card against CPU, one superset step at batch 2: the gradient norm is held
# to 10x the flagship's 1e-3, the losses to the flagship's 1e-4. GDANet's
# selections there differ on 23,286 of 227,328 picks (19,562 in the first
# GDM's k = 64 kNN), and almost none are float32 near-ties (phase 6 reads
# them, ``gdanet_readings``): the two devices hand GDANet the same 512 ranked
# queries (matched within 2e-7) but with one near-tied pair swapped, and the
# reference's normals are a reshaped buffer (models/seg_adapointr.py:
# _scrambled_normals), so that swap gives 6 points other normals, up to 1.2
# apart. In the CPU's point labels the first kNN (on the coordinates) then
# agrees exactly, the first GDM's picks differ on 19,551 from those 6
# points' features on, and only 34 picks, in the k = 30 kNNs of blocks 2-3,
# are ties within 8 ulps. Each differing pick changes a point's edge
# feature and the gradient through it; the step's gradient norm still
# agrees to 4.5e-4 relative on the H100.
SUPERSET_GRAD_NORM_TOL = 1e-2
# a differing GDANet pick is a near-tie of the CPU's float32 scores when its
# gap is at most this many float32 ulps of the row's largest |score|
PICK_GAP_ULPS = 8

# the matmul-form distance per pair: |x|^2 + |y|^2 - 2 cross as a bf16
# product of inner length 15 with float32 sums (the cross term's 9 products
# and the norms' 3 + 3 exact parts: 15 multiplies and 14 adds), a
# tensor-core operation; then one compare per direction, in float32
OPS_PAIR_MXU_TC = 29
OPS_PAIR_MXU_F32 = 2
# The JAX package's band for the matmul-form selection
# (tests/test_pallas_kernels.py:145, benchmarks/kernels.py:180-197): the
# share of equal indices, the sqrt-abs difference of a selected distance, and
# CD-L1 and CD-L2 x1000 recomputed from the indices
MXU_BAND = {"equal": 0.999, "sqrt_abs": 2e-3, "cd_x1000": 1e-3}
# The kernel against its plain version: a pick may exceed the plain
# version's pick, in the plain version's own arithmetic, by MXU_GAP of the
# pair's |x|^2 + |y|^2 (8 float32 ulps: the tensor cores' order of fifteen
# adds) and MXU_TRUNC of |d~| (the kernel's key drops the low 6 of d~'s 24
# bits). A key that misorders near-coincident candidates shows here: one
# that ranks negative d~ by the wrong end moves picks on the dense sphere by
# about 3.3e-6 of |x|^2 + |y|^2.
MXU_GAP = 2.0 ** -20
MXU_TRUNC = 2.0 ** -17
# the fused 3-NN's weighted sum per output element: 3 multiplies, 2 adds
OPS_INTERP_ELEM = 5
# kNN's issue slots a candidate pair: the 8 pinned float operations, the
# threshold test and the tile load, the ballot and the loop shared by 32
# (csrc/knn.cu); its floor spreads them over 132 SMs x 4 schedulers x 32
# lanes at the card's clock
KNN_SLOTS_PAIR = 10
# FPS: issue slots a point in the pass (8 pinned float operations, the
# minimum, the tree's compare and 5 selects) and the cycles of the chain
# after it that no block width shortens (two warp reductions, a
# shared-memory write and read, one barrier): an estimate, not a reading
FPS_SLOTS_POINT = 15
FPS_CHAIN_CYCLES = 100
# the deformable config's block lists (cfgs/PCN_models/AdaPoinTr.yaml otherwise)
DEFORM_LISTS = {
    "encoder": ["attn-rw_deform", "attn-deform", "attn-deform_graph", "attn", "attn", "attn"],
    "self": ["attn-deform", "attn-deform_graph", "attn-rw_deform"] + ["attn"] * 5,
    "cross": ["attn-deform", "attn-deform_graph"] + ["attn"] * 6,
}
MXU_FLAG = "IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER"
IMAGE_BAND = 1e-4  # ResNet50 / ConvNeXt card vs CPU: max |diff| over the output's max |value|
# phase 9: the five PCN baselines, their timed train steps, the k = 2 config
BASELINE_STEPS = 3
K2 = "cfgs/PCN_models/AdaPoinTr-tiny-k2.yaml"
N_GT = 16384  # the PCN ground truth
GRNET_CELLS = 64**3

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
# phase 10
PROFILE_STEPS = 7  # --profile traces steps 1-5 and stops before step 6
N_CLI_PARTIAL = 1800  # the CLI's cloud: upsampled to 2048
TXT_ATOL = 1e-6
LOADER_BATCHES = 6
LOADER_WORKERS = 8
CLASS_ID = "03001627"
CLASSES = {"02691156": 0, CLASS_ID: 3}
# the CUDA function each kernel of the flagship step launches, as the profiler names it
STEP_KERNEL_EVENTS = {"knn": "knn_kernel", "fps": "fps_kernel", "gather_rows": "gather_rows",
                      "nn_bidir_argmin": "nn_bidir_kernel", "scatter_add_rows": "scatter_add_rows"}
PORTED_KERNEL_NAMES = ("nn_bidir_kernel", "knn_kernel", "knn_merge_kernel", "fps_kernel", "gather_rows",
                       "scatter_add_rows", "nn_one_direction", "weighted_gather_sum",
                       "dfeats_kernel", "dweights_kernel", "auction_top2", "three_nn_interp_kernel",
                       "nn_bidir_mxu")


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


def fine_points(cfg) -> int:
    """Points of the model's fine cloud: num_query times the rebuild factor
    (64 under ``decoder_type: fold``, whatever ``num_points`` says)."""
    return int(cfg.num_query) * rebuild_factor(cfg)


def grouper_calls(cfg, train: bool):
    """(knn, fps, gathers whose table needs no gradient, gathers whose
    table does) of the grouper over ``N_PARTIAL`` points. DGCNN: four
    k = 16 searches, FPS 2048 -> n1 -> n2, the edge convolutions' gathers
    (in train mode layer 1 gathers the raw coordinates and the FPS
    gathers of the coordinates need none). ``pn``: FPS to n2 centres, their
    k = 32 nearest input points, both gathers of the input, which needs no
    gradient."""
    n1, n2 = (int(n) for n in cfg.center_num)
    N = N_PARTIAL
    if cfg.encoder_type == "pn":
        return [(32, n2, N)], [(N, n2)], [(N, 3, n2), (N, 3, n2 * 32)], []
    kg = 16
    knn = [(kg, N, N), (kg, n1, N), (kg, n1, n1), (kg, n2, n1)]
    fps = [(N, n1), (n1, n2)]
    if not train:
        return knn, fps, [(N, 8, N * kg), (N, 3, n1), (N, 32, n1), (N, 32, n1 * kg), (n1, 64, n1 * kg),
                          (n1, 3, n2), (n1, 64, n2), (n1, 64, n2 * kg)], []
    return knn, fps, [(N, 3, N * kg), (N, 3, n1), (n1, 3, n2)], [
        (N, 32, n1), (N, 32, n1 * kg), (n1, 64, n1 * kg), (n1, 64, n2), (n1, 64, n2 * kg)]


def request_calls(cfg) -> dict:
    """Each kernel's calls in one eval request plus its metrics, per batch
    element count, from the model config: knn (k, S, M), fps (N, npoint),
    gather_rows (M, C, S), nn_bidir_argmin (N, M), weighted_gather_sum
    (S, K, M, C), three_nn_interpolate (groups, S, M, C; the batch times
    the groups is the kernel's). A segmentation model adds one GDANet pass:
    on the ranked queries (the superset) or on the encoder centres
    (SegEncAdaPoinTr). The ``pn`` grouper and the ``fold`` head (64
    points a query) change the grouper's and the metrics' calls."""
    n1, n2 = (int(n) for n in cfg.center_num)
    nq, n_pred, n_gt = int(cfg.num_query), fine_points(cfg), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd = int(enc.embed_dim), int(enc.k), int(dec.k)
    g = int(enc.get("n_group", 2))
    n_cand = nq + nq // 2  # coarse_pred queries + FPS seeds, before ranking
    N = N_PARTIAL
    knn, fps, gather, _ = grouper_calls(cfg, train=False)
    knn += [(ke, n2, n2),  # encoder, shared by the stack
            (kd, nq, nq), (kd, nq, n2)]  # decoder self and cross
    fps += [(N, nq // 2)]
    gather += [(N, 3, nq // 2), (n_cand, 3, nq)]  # query seeds, ranking
    interp = []
    enc_t, self_t, cross_t = _tokens(cfg)
    for tokens, n_q, n_v, k in ((enc_t, n2, n2, ke), (self_t, nq, nq, kd), (cross_t, nq, n2, kd)):
        for t in filter(None, tokens):  # every index is given by the stack
            _, offsets, rows, it = _local_calls(t, C, g, n_q, n_v, k)
            gather += offsets + rows
            interp += it
    gather += [(n_gt, 3, n_pred), (n_pred, 3, n_gt)]  # metric residuals, both directions
    calls = {"knn": knn, "fps": fps, "gather_rows": gather,
             "nn_bidir_argmin": [(n_pred, n_gt)], "weighted_gather_sum": [],
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
    nq, n_pred, n_gt = int(cfg.num_query), fine_points(cfg), int(cfg.num_points)
    enc, dec = cfg.encoder_config, cfg.decoder_config
    C, ke, kd = int(enc.embed_dim), int(enc.k), int(dec.k)
    g = int(enc.get("n_group", 2))
    n_cand, L, Q = nq + nq // 2, DENOISE, nq + DENOISE
    factor = n_pred // nq
    N = N_PARTIAL
    knn, fps, gather, grad_gathers = grouper_calls(cfg, train=True)
    knn += [(ke, n2, n2), (kd, Q, n2)]
    # gathers whose table needs a gradient: their backward is one scatter each
    grad_gathers += [(n_cand, 3, nq)]
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
    knn += [(factor, L, n_gt)]  # denoise targets
    fps += [(N, nq // 2), (N, L)]
    chamfer = [(L * factor, L * factor), (nq, n_gt), (n_pred, n_gt)]  # (pred, target)
    gather += [(N, 3, nq // 2), (N, 3, L), (n_gt, 3, L * factor)]  # seeds, denoise targets
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
    nq, n_pred, n_gt = int(cfg.num_query), fine_points(cfg), int(cfg.num_points)
    calls = {k: list(v) for k, v in request_calls(cfg).items()}
    if mxu:
        calls["nn_bidir_mxu"] = calls["nn_bidir_argmin"]
        calls["nn_bidir_argmin"] = []
    calls["nn_bidir_argmin"].append((nq, n_gt))
    calls["gather_rows"] += [(n_gt, 3, nq), (nq, 3, n_gt)]
    calls.update(scatter_add_rows=[], nn_one_direction=[])
    if protocol == "test":
        calls["nn_one_direction"] = [(n_pred, n_gt), (n_gt, n_pred)]
        calls["gather_rows"] += [(n_gt, 3, n_pred), (n_pred, 3, n_gt)] * 2
        calls["nn_bidir_argmin"].append((n_pred, n_gt))
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
    means (kernel, library) of each, and every pair. With no library call
    (None) the kernel is timed twice and the library's mean is None."""
    out = {}
    for how, timer in (("graph", graph_ms), ("loop", cuda_ms)):
        k1 = timer(kernel, reps[0])
        ls = [timer(library, reps[1]) for _ in range(2)] if library else []
        k2 = timer(kernel, reps[0])
        out[how] = ((k1 + k2) / 2, sum(ls) / 2 if ls else None)
        out.setdefault("pairs", {})[how] = [k1, *ls, k2]
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout.split()[0]
    return float(mhz) * 1e6


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sphere(g, b, n, dev):
    v = torch.randn(b, n, 3, generator=g, dtype=torch.float64)
    return (0.5 * v / v.norm(dim=-1, keepdim=True)).float().to(dev)


# ------------------------------------------------------------ phase 2 checks


def knn_probes(g, dev) -> list:
    """(k, ref, query) probes beyond the paths' shapes: M below a warp's 32
    candidates, M off the tile and the chunk, one query (twice: one chunk,
    and the split route), k = 64 (two list slots a lane); every point twice,
    half a cloud apart, with queries on points, at the denoise call's shape
    (the split route: equal distances meet in the merge); three distinct
    points repeated with k = 16 (the list fills with ties; no empty slot
    may come out)."""
    out = [(k, torch.randn(b, M, 3, generator=g).to(dev), torch.randn(b, S, 3, generator=g).to(dev))
           for b, (k, S, M) in ((2, (16, 100, 20)), (B_TRAIN, (32, 64, 12345)), (2, (16, 1, 2048)),
                                (2, (64, 1, 16384)), (3, (64, 70, 1500)))]
    half = torch.randn(B_TRAIN, 8192, 3, generator=g).to(dev)
    query = torch.cat([half[:, :DENOISE // 2], torch.randn(B_TRAIN, DENOISE // 2, 3, generator=g).to(dev)], 1)
    out.append((32, torch.cat([half, half], 1).contiguous(), query.contiguous()))
    few = torch.randn(2, 3, 3, generator=g).to(dev).repeat(1, 1400, 1)
    out.append((16, few, torch.cat([few[:, :5], torch.zeros(2, 3, 3, device=dev)], 1).contiguous()))
    return out


def check_knn(calls, extra, g, dev):
    """knn_with_distance against knn_plain at every shape the paths give it
    (the serving request's at ``B``; ``extra``: the flagship, superset and
    deformable train steps' at ``B_TRAIN``, the segmentation models' and
    the deformable request's at ``B``) and at :func:`knn_probes`: indices
    equal and distances bit-equal (both take the diff form without
    contraction, and the kernel's split route merges its chunks' k-lists by
    (distance, index), exactly); two runs give the same bits. Timed by
    :func:`time_knn`."""
    cases = batched(calls, extra)
    inputs = [(k, torch.randn(b, M, 3, generator=g).to(dev), torch.randn(b, S, 3, generator=g).to(dev))
              for b, (k, S, M) in cases] + knn_probes(g, dev)
    err = 0.0
    for n, (k, ref, q) in enumerate(inputs):
        d, i = ops.knn_with_distance(k, ref, q)
        pd, pi = ops.knn_plain(k, ref, q)
        what = f"knn k={k} {tuple(q.shape)}x{tuple(ref.shape)}"
        require(torch.equal(i, pi), f"{what}: indices differ")
        err = max(err, float((d - pd).abs().max()))
        require(torch.equal(d, pd), f"{what}: distances differ by {err}")
        if n < len(calls) or n >= len(cases):
            d2, i2 = ops.knn_with_distance(k, ref, q)
            require(torch.equal(d2, d) and torch.equal(i2, i), f"{what}: two runs differ")
    split = sorted({(int(r.shape[0]), k, int(q.shape[1]), int(r.shape[1]),
                     pointops.knn_chunks(r.shape[0], q.shape[1], r.shape[1], dev)) for k, r, q in inputs})
    log("phase 2: knn (B, k, S, M, chunks) checked: " + json.dumps([c for c in split if c[-1] > 1])
        + f" split, {sum(c[-1] == 1 for c in split)} shapes in one chunk")

    t = time_knn(calls, g, dev)
    t["plain_ms"] = cuda_ms(lambda: [ops.knn_plain(k, r, q) for k, r, q in inputs[:len(calls)]], 5)
    pairs = sum(B * S * M for _, S, M in calls)
    nbytes = sum(B * (S + M) * 12 + B * S * k * 12 for k, S, M in calls)
    return err, t, pairs * OPS_PAIR_ONE_WAY, nbytes


def time_knn(calls, g, dev) -> dict:
    """kNN's times by graph replay and host loop in turns with
    ``cdist().topk``, on new random clouds: the request's ``calls`` at
    ``B``, the flagship step's at ``B_TRAIN``, its denoise-target call alone
    and the normals' call (k = 30, the superset request's); each with its
    bound by operations, and in the log an estimated issue-slot floor
    (``KNN_SLOTS_PAIR`` slots a pair on every lane of the card at its
    clock). Only the public op is
    called, so the same code times an older tree's kernel."""
    cfg = cfg_from_yaml_file(CONFIG).model
    step = train_step_calls(cfg)["knn"]
    sets = {"request": (B, calls), "step": (B_TRAIN, step), "denoise": (B_TRAIN, step[-1:]),
            "normals": (B, gdanet_calls(int(cfg.num_query))["knn"])}
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t, more = {}, {}
    for name, (b, cs) in sets.items():
        timed = [(k, torch.randn(b, M, 3, generator=g).to(dev), torch.randn(b, S, 3, generator=g).to(dev))
                 for k, S, M in cs]
        turns = in_turns(lambda: [ops.knn_with_distance(k, r, q) for k, r, q in timed],
                         lambda: [torch.cdist(q, r).topk(k, largest=False) for k, r, q in timed])
        pairs = sum(b * S * M for _, S, M in cs)
        floor = pairs * KNN_SLOTS_PAIR / (sms * 4 * 32 * clock) * 1e3
        log(f"phase 2: knn, the {name}'s {len(cs)} calls at batch {b}, in turns: graph replay "
            f"{turns['graph'][0]:.4f} ms (cdist + topk {turns['graph'][1]:.4f} ms), host loop "
            f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); {pairs} pairs, estimated issue-slot floor "
            f"{floor:.5f} ms; each pair {json.dumps(turns['pairs'])}")
        if name == "request":
            t = {"ms": turns["graph"][0], "loop_ms": turns["loop"][0], "library_ms": turns["graph"][1],
                 "library_loop_ms": turns["loop"][1]}
        else:
            more.update({f"{name}_ms": turns["graph"][0], f"{name}_loop_ms": turns["loop"][0],
                         f"{name}_library_ms": turns["graph"][1], f"{name}_library_loop_ms": turns["loop"][1],
                         f"{name}_bound_ms": pairs * OPS_PAIR_ONE_WAY / PEAK_F32 * 1e3})
    t["more"] = more
    return t


def fps_step_cycles(n: int) -> int:
    """The least cycles of one dependent FPS step over n points: the pass
    issues ``FPS_SLOTS_POINT`` slots a point on the SM's 128 lanes, then the
    chain that no width shortens, ``FPS_CHAIN_CYCLES``."""
    return -(-n // 128) * FPS_SLOTS_POINT + FPS_CHAIN_CYCLES


def crop_cloud(g, dev) -> torch.Tensor:
    """A batch of what the ShapeNet-55 train crop hands FPS (64 x 8192):
    sphere clouds sorted by distance to a random unit direction, their
    nearest ``num_crop`` rows replaced by copies of the farthest point; the
    first two clouds cropped by the least and the most (2048 and 6144)."""
    gt = sphere(g, B_SHAPENET, N_SHAPENET, dev)
    center = sampling._unit_center(torch.randn(B_SHAPENET, 1, 3, generator=g).to(dev))
    num_crop = torch.randint(N_SHAPENET // 4, 3 * N_SHAPENET // 4 + 1, (B_SHAPENET, 1), generator=g)
    num_crop[0], num_crop[1] = N_SHAPENET // 4, 3 * N_SHAPENET // 4
    return sampling.train_crop_kept(gt, center, num_crop.to(dev))


def recipe_fps_inputs(g, dev) -> list:
    """(cloud, picks) at the recipes' FPS shapes (phase 8), made by the
    recipes' own transforms: the ShapeNet-55 train crop (:func:`crop_cloud`,
    -> 2048); the test crops of ``B_VAL`` clouds towards the 8 viewpoints in
    each mode (16 x 6144 | 4096 | 2048 -> 2048, viewpoint-major as
    ``Runner.crop_eval_rows`` builds them); the KITTI dropping's partials
    (16 x 2048 -> 768, zero rows past each cloud's points, as the PCN
    reader pads them)."""
    out = [(crop_cloud(g, dev), N_PARTIAL)]
    views = port_runner.SHAPENET55_VIEWPOINTS
    clouds = sphere(g, B_VAL, N_SHAPENET, dev).repeat(len(views), 1, 1)
    view_rows = torch.tensor(views, dtype=torch.float32, device=dev).repeat_interleave(B_VAL, 0)
    for ratio in port_runner.CROP_RATIO.values():
        partial, _ = sampling.separate_point_cloud(clouds, int(N_SHAPENET * ratio), fixed_point=view_rows)
        out.append((partial, N_PARTIAL))
    partial = torch.randn(B_TRAIN, N_PARTIAL, 3, generator=g)
    keep = torch.randint(1200, N_PARTIAL + 1, (B_TRAIN, 1), generator=g)
    partial[torch.arange(N_PARTIAL)[None] >= keep] = 0.0
    out.append((partial.to(dev), DROP_POINTS))
    return out


def check_fps(calls, extra, g, dev):
    """furthest_point_sample against fps_plain (picks equal; two runs
    equal) at the request's, the step's and the segmentation models' shapes,
    the recipes' (:func:`recipe_fps_inputs`: the ShapeNet-55 train crop's
    clouds with up to 6144 duplicate rows, its test crops, the KITTI
    dropping's zero-padded partials) and probes: N = 14511 (the old limit)
    and 16384 (the new one), N off threads x points a thread, one point, one
    pick, more picks than points; identical points (every padded slot and
    tie must lose to index 0) at widths off the block's; a cloud past the
    limit raises. Timed by :func:`time_fps`."""
    probes = [(2, (14511, 64)), (1, (16384, 32)), (3, (1000, 999)), (2, (2049, 300)), (2, (1, 4)),
              (2, (300, 1)), (2, (50, 80))]
    inputs = [(torch.randn(b, N, 3, generator=g).to(dev), n) for b, (N, n) in batched(calls, extra) + probes]
    recipes = recipe_fps_inputs(g, dev)
    err = 0.0
    for xyz, n in inputs + recipes:
        got = ops.furthest_point_sample(xyz, n)
        err = max(err, float((got - ops.fps_plain(xyz, n)).abs().max()))
        require(err == 0.0, f"fps {tuple(xyz.shape)}->{n}: picks differ")
        require(torch.equal(ops.furthest_point_sample(xyz, n), got), f"fps {tuple(xyz.shape)}->{n}: two runs differ")
    log("phase 2: fps at the recipes' shapes, bit-equal to the plain version: "
        + json.dumps([[*xyz.shape[:2], n] for xyz, n in recipes]))
    for n_pts, picks in ((N_PARTIAL, 512), (1, 16), (33, 16), (1025, 16), (8193, 16)):
        same = torch.full((B, n_pts, 3), 0.25, device=dev)
        require(torch.equal(ops.furthest_point_sample(same, picks),
                            torch.zeros(B, picks, dtype=torch.int64, device=dev)),
                f"fps on {n_pts} identical points must pick index 0 throughout")
    limit = _build.library().fps_max_points()
    require(limit >= 14511, f"fps holds only {limit} points")
    try:
        ops.furthest_point_sample(torch.zeros(1, limit + 1, 3, device=dev), 4)
        require(False, "fps past its limit must raise")
    except ValueError:
        pass
    t = time_fps(calls, g, dev)
    t["plain_ms"] = cuda_ms(lambda: [ops.fps_plain(x, n) for x, n in inputs[:len(calls)]], 2)
    crop, n = recipes[0]
    t["more"]["crop_plain_ms"] = cuda_ms(lambda: ops.fps_plain(crop, n), 1)
    # every step folds N distances into the cache and takes their argmax
    n_ops = sum(B * (n - 1) * N * (OPS_PAIR_ONE_WAY + 1) for N, n in calls)
    nbytes = sum(B * (N * 12 + n * 8) for N, n in calls)
    return err, t, n_ops, nbytes


def time_fps(calls, g, dev) -> dict:
    """FPS's times by graph replay and host loop in turns, on new random
    clouds: the request's ``calls`` at ``B``, and beside them the ShapeNet-55
    train crop's one call (:func:`crop_cloud`, 64 x 8192 -> 2048, the
    ``<16, 512>`` route) with its bound (``crop_*``) and SnowFlakeNet's
    loss call (64 x 16384 -> 2048 on sphere clouds, the ``<16, 1024>``
    route) with its bound and plain time (``snowflake_*``); in the log an
    estimated latency floor of each: the dependent steps times
    :func:`fps_step_cycles` at the card's clock."""
    timed = [(torch.randn(B, N, 3, generator=g).to(dev), n) for N, n in calls]
    turns = in_turns(lambda: [ops.furthest_point_sample(x, n) for x, n in timed], None)
    steps = sum(n - 1 for _, n in calls)
    floor = sum((n - 1) * fps_step_cycles(N) for N, n in calls) / sm_clock_hz() * 1e3
    t = {"ms": turns["graph"][0], "loop_ms": turns["loop"][0], "library_ms": None}
    log(f"phase 2: fps, the request's {len(calls)} calls at batch {B} ({steps} dependent steps), in turns: "
        f"graph replay {t['ms']:.4f} ms ({t['ms'] * 1e3 / steps:.4f} us a step), host loop {t['loop_ms']:.4f} ms; "
        f"estimated latency floor {floor:.4f} ms; each pair {json.dumps(turns['pairs'])}")
    crop = crop_cloud(g, dev)
    crop_turns = in_turns(lambda: ops.furthest_point_sample(crop, N_PARTIAL), None, reps=(20, 20))
    op_ms = B_SHAPENET * (N_PARTIAL - 1) * N_SHAPENET * (OPS_PAIR_ONE_WAY + 1) / PEAK_F32 * 1e3
    byte_ms = B_SHAPENET * (N_SHAPENET * 12 + N_PARTIAL * 8) / PEAK_BYTES * 1e3
    crop_floor = (N_PARTIAL - 1) * fps_step_cycles(N_SHAPENET) / sm_clock_hz() * 1e3
    t["more"] = {"crop_ms": crop_turns["graph"][0], "crop_loop_ms": crop_turns["loop"][0],
                 "crop_bound_ms": max(op_ms, byte_ms), "crop_bound_by": "operations" if op_ms >= byte_ms else "bytes",
                 "crop_shape": [B_SHAPENET, N_SHAPENET, N_PARTIAL]}
    log(f"phase 2: fps, the ShapeNet-55 crop's call {B_SHAPENET} x {N_SHAPENET} -> {N_PARTIAL}, in turns: graph "
        f"replay {crop_turns['graph'][0]:.4f} ms ({crop_turns['graph'][0] * 1e3 / (N_PARTIAL - 1):.4f} us a step), "
        f"host loop {crop_turns['loop'][0]:.4f} ms; bound {max(op_ms, byte_ms):.4f} ms; estimated latency floor "
        f"{crop_floor:.4f} ms; each pair {json.dumps(crop_turns['pairs'])}")
    # SnowFlakeNet's loss: fps(gt, 2048) of its 16384-point ground truth at 64 (the <16, 1024> route)
    b, n, picks = 64, N_GT, 2048
    gt = sphere(g, b, n, dev)
    sf = in_turns(lambda: ops.furthest_point_sample(gt, picks), None, reps=(10, 10))
    op_ms = b * (picks - 1) * n * (OPS_PAIR_ONE_WAY + 1) / PEAK_F32 * 1e3
    byte_ms = b * (n * 12 + picks * 8) / PEAK_BYTES * 1e3
    sf_floor = (picks - 1) * fps_step_cycles(n) / sm_clock_hz() * 1e3
    t["more"].update({"snowflake_ms": sf["graph"][0], "snowflake_loop_ms": sf["loop"][0],
                      "snowflake_plain_ms": cuda_ms(lambda: ops.fps_plain(gt, picks), 1),
                      "snowflake_bound_ms": max(op_ms, byte_ms),
                      "snowflake_bound_by": "operations" if op_ms >= byte_ms else "bytes",
                      "snowflake_shape": [b, n, picks]})
    log(f"phase 2: fps, SnowFlakeNet's loss call {b} x {n} -> {picks} (the <16, 1024> route), in turns: graph "
        f"replay {sf['graph'][0]:.4f} ms ({sf['graph'][0] * 1e3 / (picks - 1):.4f} us a step), host loop "
        f"{sf['loop'][0]:.4f} ms; plain {t['more']['snowflake_plain_ms']:.4f} ms; bound {max(op_ms, byte_ms):.4f} ms; "
        f"estimated latency floor {sf_floor:.4f} ms; each pair {json.dumps(sf['pairs'])}")
    return t


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
    """scatter_add_rows at every shape of the flagship train step at
    B_TRAIN (timed) and of the superset and deformable steps (``extra``),
    the mirror direction of each chamfer cross term, and probes: the kernel
    sums each output element in increasing source order, so it must equal
    the plain version run on the CPU bit for bit, and a second launch on the
    same inputs must give the same bits. Indices run 3 past both ends, so
    every case also clamps."""
    Bt = B_TRAIN
    mirror = [(S, C, rows) for rows, C, S in calls[:3]]
    cases = list(dict.fromkeys([(Bt, c) for c in list(calls) + mirror] + list(extra)))

    def held(what, n_rows, idx, vals):
        got = ops.scatter_add_rows(n_rows, idx.to(dev), vals.to(dev))
        again = ops.scatter_add_rows(n_rows, idx.to(dev), vals.to(dev))
        want = ops.scatter_add_rows_plain(n_rows, idx, vals)  # on the CPU
        require(torch.equal(got.cpu(), want), f"scatter_add_rows {what}: not bit-equal to the plain version")
        require(torch.equal(got, again), f"scatter_add_rows {what}: two launches differ")
        return got

    for b, (rows, C, S) in cases:
        idx = torch.randint(-3, rows + 3, (b, S), generator=g)
        held(f"{b}x(rows={rows} C={C} S={S})", rows, idx, torch.randn(b, S, C, generator=g))
    for C in (3, 384):  # a permutation: every row receives one contribution
        n = 16384 if C == 3 else 4608
        idx = torch.stack([torch.randperm(n, generator=g) for _ in range(Bt)])
        vals = torch.randn(Bt, n, C, generator=g)
        got = held(f"permutation C={C}", n, idx, vals)
        require(torch.equal(ops.gather_rows(got, idx.to(dev)).cpu(), vals), "scatter then gather is not the identity")
    for rows, row in ((512, 7), (16384, 0)):  # 16384 contributions to one row
        got = held(f"all indices {row} of {rows}", rows, torch.full((2, 16384), row), torch.randn(2, 16384, 3, generator=g))
        got[:, row] = 0.0
        require(int(got.count_nonzero()) == 0, "all indices equal: other rows touched")
    idx = torch.randint(-4, 516, (2, 4096), generator=g)  # out-of-range indices clamp
    idx[:, :3] = torch.tensor([-1, 512, 512 + 10**6])
    held("clamp", 512, idx, torch.randn(2, 4096, 8, generator=g))
    held("mostly empty rows", 4096, torch.randint(0, 4096, (1, 200), generator=g), torch.randn(1, 200, 384, generator=g))
    for rows, S in ((20000, 5000), (100, 40000)):  # past 16384 rows or sources: the global-scratch route
        held(f"{rows} rows {S} sources", rows, torch.randint(0, rows, (2, S), generator=g), torch.randn(2, S, 5, generator=g))
    t = time_scatter(calls, g, dev)
    # values and indices read once, the output written once; one add per value
    nbytes = sum(Bt * (S * (C * 4 + 8) + rows * C * 4) for rows, C, S in calls)
    return 0.0, t, sum(Bt * S * C for _, C, S in calls), nbytes


def time_scatter(calls, g, dev) -> dict:
    """scatter_add_rows over one train step's calls ``calls`` (rows, C, S)
    at B_TRAIN, by graph replay and host loop in turns with ``index_add_``,
    and the plain version on the card. Public ops only, so it times an older
    tree too."""
    Bt = B_TRAIN
    step = [(r, torch.randint(0, r, (Bt, S), generator=g).to(dev), torch.randn(Bt, S, C, generator=g).to(dev))
            for r, C, S in calls]
    offs = [(i + torch.arange(Bt, device=dev)[:, None] * r).reshape(-1) for r, i, _ in step]

    def library():
        for (r, _, v), off in zip(step, offs):
            torch.zeros(Bt * r, v.shape[-1], device=dev).index_add_(0, off, v.reshape(-1, v.shape[-1]))

    turns = in_turns(lambda: [ops.scatter_add_rows(r, i, v) for r, i, v in step], library, reps=(20, 20))
    log(f"phase 2: scatter_add_rows over one train step's {len(calls)} calls at {Bt}, in turns: graph replay "
        f"{turns['graph'][0]:.4f} ms (index_add_ {turns['graph'][1]:.4f} ms), host loop {turns['loop'][0]:.4f} ms "
        f"({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    return {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
            "plain_ms": cuda_ms(lambda: [ops.scatter_add_rows_plain(r, i, v) for r, i, v in step], 20),
            "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1]}


def check_one_direction(calls, extra, g, dev):
    """nn_one_direction: unmasked at the chamfer losses' sizes (equal to
    the plain version and to the bidirectional kernel's first direction),
    then masked, and at the probes of the candidate chunks merged by a 64-bit
    atomicMin: points duplicated half a cloud apart at 1 x 16384 x 16384
    (ties across chunks; unmasked every pick a first copy), a batch element
    with no valid candidate (index 0), one query, one candidate, M off the
    chunk size, and rows that fill the card alone (one chunk, written
    directly); a second launch gives the same indices. Timed over one test
    cloud's two masked calls by ``time_one_direction``."""
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

    def held(what, x, y, wy):
        got = ops.nn_one_direction(x, y, wy)
        require(torch.equal(got, ops.nn_one_direction_plain(x, y, wy)), f"nn_one_direction {what}: differs from plain")
        require(torch.equal(got, ops.nn_one_direction(x, y, wy)), f"nn_one_direction {what}: two launches differ")
        return got

    h = M // 2  # duplicates half a cloud apart, queries on them
    x, y = sphere(g, 1, N, dev), sphere(g, 1, M, dev)
    y[:, h:] = y[:, :M - h]
    x[:, ::2] = y[:, torch.randint(0, M, (len(range(0, N, 2)),), generator=g).to(dev)]
    require(bool((held("duplicates", x, y, None) < h).all()), "nn_one_direction duplicates: a second copy won")
    wy = torch.ones(1, M, device=dev)
    wy[:, :h] = (torch.rand(1, h, generator=g) > 0.5).float().to(dev)
    held("duplicates, some first copies masked", x, y, wy)
    x, y = sphere(g, 2, 3000, dev), sphere(g, 2, M, dev)
    wy = (torch.rand(2, M, generator=g) > 0.5).float().to(dev)
    wy[1] = 0.0
    require(bool(held("no valid candidate", x, y, wy)[1].eq(0).all()), "nn_one_direction: no valid y must give 0")
    for b, n, m in ((1, 1, M), (1, N, 1), (1, 5000, M - 5), (3, 700, 257), (800, 64, 64)):
        held(f"{b}x{n}x{m}", sphere(g, b, n, dev), sphere(g, b, m, dev),
             (torch.rand(b, m, generator=g) > 0.3).float().to(dev))
    t = time_one_direction(N, M, g, dev)
    pairs = sum(n * m for n, m in calls)
    return 0.0, t, pairs * OPS_PAIR_ONE_WAY, sum((n + m) * 12 + m * 4 + n * 8 for n, m in calls)


def time_one_direction(N: int, M: int, g, dev) -> dict:
    """nn_one_direction over one test cloud's two masked calls at batch 1
    (N x M, then M x N), by graph replay and host loop in turns with
    ``cdist`` and its argmin, and the plain version on the card. Public ops
    only, so it times an older tree too."""
    x, y = torch.randn(1, N, 3, generator=g).to(dev), torch.randn(1, M, 3, generator=g).to(dev)
    wx, wy = torch.ones(1, N, device=dev), torch.ones(1, M, device=dev)

    def both(fn):
        return lambda: (fn(x, y, wy), fn(y, x, wx))

    turns = in_turns(both(ops.nn_one_direction),
                     lambda: (torch.cdist(x, y).argmin(-1), torch.cdist(y, x).argmin(-1)), reps=(50, 10))
    log(f"phase 2: nn_one_direction over one test cloud's two calls at 1x{N}x{M}, in turns: graph replay "
        f"{turns['graph'][0]:.4f} ms (cdist + argmin {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    return {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
            "plain_ms": cuda_ms(both(ops.nn_one_direction_plain), 2),
            "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1]}


def check_weighted_gather_sum(calls, extra, g, dev):
    """weighted_gather_sum at the segmentation models' request shapes,
    held to 1e-5 of each element's sum of absolute terms and to the same
    bits in two launches (each output's terms added in ascending m);
    out-of-range indices (two in three in a probe) must contribute nothing,
    also where the row they read (clamped, then skipped) holds inf and NaN.
    Timed over one superset request's calls by graph replay and host loop,
    in turns with ``embedding_bag`` with per-sample weights (one PyTorch
    call for the same sum)."""
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
        require(torch.equal(got, ops.weighted_gather_sum(w, idx, feats)),
                f"weighted_gather_sum {(b, S, K, M, C)}: two launches differ")
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
    poisoned = feats.clone()  # row 0, read by the out-of-range indices, reached by no valid one
    poisoned[:, 0, ::2], poisoned[:, 0, 1::2] = float("inf"), float("nan")
    clear = bad.masked_fill(bad == 0, 1)
    require(bool(torch.isfinite(ops.weighted_gather_sum(w, clear, poisoned)).all()),
            "weighted_gather_sum: the row an out-of-range index reads leaked into the sum")
    t = time_gather_sum(calls, g, dev)
    # weights, indices and the table read once, the output written once;
    # one multiply-add per (row, neighbour, channel)
    nbytes = sum(B * (S * K * (4 + 8) + M * C * 4 + S * C * 4) for S, K, M, C in calls)
    return err, t, sum(2 * B * S * K * C for S, K, M, C in calls), nbytes


def time_gather_sum(calls, g, dev) -> dict:
    """weighted_gather_sum over one superset request's calls ``calls`` ((S,
    K, M, C) at batch ``B``, distinct neighbours a row as a top-k gives them)
    by graph replay and host loop, in turns with ``embedding_bag`` with
    per-sample weights (one PyTorch call for the same sum), and the plain
    version on the card. Public ops only, so it times an older tree too."""
    inputs = []
    for S, K, M, C in calls:
        idx = torch.rand(B, S, M, generator=g).argsort(dim=-1)[..., :K].contiguous().to(dev)
        inputs.append((torch.rand(B, S, K, generator=g).to(dev), idx, torch.randn(B, M, C, generator=g).to(dev)))
    bags = [((i + torch.arange(i.shape[0], device=dev)[:, None, None] * f.shape[1]).reshape(-1, i.shape[-1]),
             f.reshape(-1, f.shape[-1]), w.reshape(-1, w.shape[-1])) for w, i, f in inputs]
    turns = in_turns(lambda: [ops.weighted_gather_sum(*a) for a in inputs],
                     lambda: [torch.nn.functional.embedding_bag(i, f, per_sample_weights=w, mode="sum")
                              for i, f, w in bags])
    log(f"phase 2: weighted_gather_sum over one superset request's {len(inputs)} calls, in turns: graph "
        f"replay {turns['graph'][0]:.4f} ms (embedding_bag {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    return {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
            "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_plain(*a) for a in inputs], 50),
            "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1]}


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
    interpolation's VJP, and at the superset train step's GDANet shapes (past
    16384 terms an element: the sort in scratch) and the tiny config's
    (``extra``): the kernel adds each row's terms in flat (s, m) order, so it
    must equal the plain version run on the CPU bit for bit, and a second
    launch must give the same bits. Probes: two in three indices out of
    range (they add nothing), every term in one row, and a row that no term
    reaches. Timed by ``time_dfeats``."""
    inputs = gather_sum_backward_inputs(calls, g, dev, distinct=False)
    inputs += gather_sum_backward_inputs(extra, g, dev)

    def held(what, w, idx, cot, M):
        got = ops.weighted_gather_sum_dfeats(w, idx, cot, M)
        want = ops.weighted_gather_sum_dfeats_plain(w.cpu(), idx.cpu(), cot.cpu(), M)
        require(torch.equal(got.cpu(), want), f"dfeats {what}: not bit-equal to the plain version")
        require(torch.equal(got, ops.weighted_gather_sum_dfeats(w, idx, cot, M)), f"dfeats {what}: two launches differ")
        return got

    for w, idx, feats, cot in inputs:
        held(f"{tuple(w.shape)} M={feats.shape[1]} C={cot.shape[-1]}", w, idx, cot, feats.shape[1])
    w, idx, feats, cot = inputs[0]
    M = feats.shape[1]
    bad = idx.clone()  # two in three out of range
    bad[..., 0::3] = -1
    bad[..., 1::3] += M
    got = held("out-of-range indices", w, bad, cot, M)
    only_valid = ops.weighted_gather_sum_dfeats(w.masked_fill((bad < 0) | (bad >= M), 0.0), bad, cot, M)
    require(torch.equal(got, only_valid), "dfeats: an out-of-range index contributed")
    one = held("every term in one row", w, torch.full_like(idx, 7), cot, M)
    require(int(one[:, 8:].count_nonzero()) == 0 and int(one[:, :7].count_nonzero()) == 0,
            "dfeats: every term in one row touched another")
    got = held("a row no term reaches", w, idx.clamp(1, M - 1), cot, M)
    require(int(got[:, 0].count_nonzero()) == 0, "dfeats: a row with no term is not zero")
    t = time_dfeats([(b, (S, M, C)) for b, (S, K, M, C) in calls], g, dev)
    # w, idx and g read once, dfeats written once; a multiply and an add per term
    nbytes = sum(b * (S * K * (4 + 8) + S * C * 4 + M * C * 4) for b, (S, K, M, C) in calls)
    return 0.0, t, sum(2 * b * S * K * C for b, (S, K, M, C) in calls), nbytes


def time_dfeats(calls, g, dev) -> dict:
    """weighted_gather_sum_dfeats over one deformable train step's 3-NN VJP
    calls ``calls`` ((batch, (S, M, C)), K = 3), by graph replay and host loop
    in turns with ``index_add_`` over the materialised (B, S, K, C) terms
    ``w * g``, and the plain version on the card. Public ops only, so it
    times an older tree too."""
    timed = [(torch.rand(b, S, 3, generator=g).to(dev), torch.randint(0, M, (b, S, 3), generator=g).to(dev),
              torch.randn(b, S, C, generator=g).to(dev), M) for b, (S, M, C) in calls]
    flat = [((i + torch.arange(i.shape[0], device=dev)[:, None, None] * M).reshape(-1), w_, c, M)
            for w_, i, c, M in timed]

    def library():
        for rows, w_, c, M in flat:
            terms = (w_[..., None] * c[:, :, None, :]).reshape(-1, c.shape[-1])
            torch.zeros(w_.shape[0] * M, c.shape[-1], device=dev).index_add_(0, rows, terms)

    turns = in_turns(lambda: [ops.weighted_gather_sum_dfeats(*a) for a in timed], library, reps=(20, 5))
    log(f"phase 2: weighted_gather_sum_dfeats over one deformable step's {len(calls)} calls, in turns: graph "
        f"replay {turns['graph'][0]:.4f} ms (index_add_ {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    return {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
            "plain_ms": cuda_ms(lambda: [ops.weighted_gather_sum_dfeats_plain(*a) for a in timed], 5),
            "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1]}


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


def grouped_inputs(cases, g, dev) -> list:
    """(pos, offset, known, v) of the grouped op for each (batch, (groups,
    S, M, C)) case, C the group width: neighbour positions (known points)
    and offsets of up to 0.05, every 7th offset zero (a query on a known
    point), v (B, M, groups C)."""
    out = []
    for b, (groups, S, M, C) in cases:
        known = torch.randn(b, M, 3, generator=g).to(dev)
        pick = torch.randint(0, M, (b, S), generator=g).to(dev)
        pos = torch.gather(known, 1, pick[..., None].expand(b, S, 3)).contiguous()
        offset = ((torch.rand(b, groups, S, 3, generator=g) - 0.5) * 0.1).to(dev)
        offset[:, :, ::7] = 0.0
        out.append((pos, offset, known, torch.randn(b, M, groups * C, generator=g).to(dev)))
    return out


def old_grouped_interpolation(pos, offset, known, v):
    """The deformable gather's interpolation as it was before the grouped
    op: the queries, the known points and the values copied into group-major
    order for the ungrouped op, the result permuted back."""
    B_, G = offset.shape[:2]
    S, (M, C) = pos.shape[1], v.shape[1:]
    shift = (pos[:, None] + offset).reshape(B_ * G, S, 3)
    known_g = known[:, None].expand(B_, G, M, 3).reshape(B_ * G, M, 3)
    v_g = v.reshape(B_, M, G, C // G).permute(0, 2, 1, 3).reshape(B_ * G, M, C // G)
    out = ops.three_nn_interpolate(shift, known_g, v_g)
    return out.reshape(B_, G, S, C // G).permute(0, 2, 1, 3).reshape(B_, S, C)


def check_three_nn(calls, extra, g, dev):
    """The fused 3-NN interpolation, grouped (the deformable gather's one
    call for every channel group, offsets added in the kernel, v and the
    result in the (B, S, C) layout) at every deformable call's shape, one
    serving request's (batch B, timed) and one train step's (B_TRAIN):
    indices equal, weights and outputs bit-equal to the plain composition
    (the kernel repeats its roundings in its order); at the train step's
    shapes the gradient in v through the grouped op bit-equal to the old
    composition's (the ungrouped op on group-major copies), and ``dfeats``
    reading the cotangent in place by groups bit-equal to ``dfeats`` on a
    contiguous copy of each group's cotangent. Probes of the ungrouped op:
    queries on known points (distance 0), duplicated known points (the
    lower index first), M = 3, C not a multiple of 4. Timed over the
    request's calls by graph replay and host loop, in turns with the
    library chain: ``cdist().topk(3)``, the weights and a gather-weighted
    sum on the group-major copies, permuted back."""
    cases = batched(calls, extra)
    inputs = grouped_inputs(cases, g, dev)
    for (b, c), (pos, off, kn, v) in zip(cases, inputs):
        out, idx, w = ops.pointops._three_nn_interpolate_grouped_forward(pos, off, kn, v, 1e-8)
        pout, pidx, pw = ops.three_nn_interpolate_grouped_plain(pos, off, kn, v)
        require(torch.equal(idx, pidx), f"three_nn_interpolate grouped {(b, c)}: indices differ")
        require(torch.equal(w, pw) and torch.equal(out, pout),
                f"three_nn_interpolate grouped {(b, c)}: values differ")
        if b != B_TRAIN:
            continue
        groups = c[0]
        cot = torch.randn(out.shape, generator=g).to(dev)
        grads = []
        for fn in (ops.three_nn_interpolate_grouped, old_grouped_interpolation):
            vv = v.clone().requires_grad_()
            fn(pos, off, kn, vv).backward(cot)
            grads.append(vv.grad)
        require(torch.equal(*grads), f"three_nn_interpolate grouped {(b, c)}: the gradient in v differs "
                                     f"from the old composition's")
        Bg, S, M = b * groups, pos.shape[1], kn.shape[1]
        w, idx = w.reshape(Bg, S, 3), idx.reshape(Bg, S, 3)
        strided = ops.weighted_gather_sum_dfeats(w, idx, cot, M, groups=groups)
        flat = cot.reshape(b, S, groups, -1).permute(0, 2, 1, 3).contiguous().reshape(Bg, S, -1)
        want = ops.weighted_gather_sum_dfeats(w, idx, flat, M).reshape(b, groups, M, -1).permute(0, 2, 1, 3)
        require(torch.equal(strided, want.reshape(b, M, -1)),
                f"dfeats by groups {(b, c)}: not bit-equal to dfeats on the contiguous copies")
    known = torch.randn(4, 576, 3, generator=g).to(dev)
    feats = torch.randn(4, 576, 192, generator=g).to(dev)
    probes = [(known[:, :300].contiguous(), known, feats),
              (known[:, :300].contiguous(), torch.cat([known, known], 1), torch.cat([feats, feats], 1)),
              (known, known[:, :3].contiguous(), feats[:, :3, :7].contiguous())]
    for u, k, f in probes:
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
        for pos, off, kn, v in timed:
            B_, G = off.shape[:2]
            S, (M, C) = pos.shape[1], v.shape[1:]
            u = (pos[:, None] + off).reshape(B_ * G, S, 3)
            k = kn[:, None].expand(B_, G, M, 3).reshape(B_ * G, M, 3)
            f = v.reshape(B_, M, G, C // G).permute(0, 2, 1, 3).reshape(B_ * G, M, C // G)
            d, i = torch.cdist(u, k).topk(3, dim=-1, largest=False)
            r = torch.reciprocal(d + 1e-8)
            w_ = r / r.sum(-1, keepdim=True)
            rows = torch.gather(f, 1, i.reshape(i.shape[0], -1, 1).expand(-1, -1, f.shape[-1]))
            (w_[..., None] * rows.reshape(*i.shape, f.shape[-1])).sum(2).reshape(B_, G, S, -1).permute(
                0, 2, 1, 3).reshape(B_, S, C)

    turns = in_turns(lambda: [ops.three_nn_interpolate_grouped(*a) for a in timed], library, reps=(20, 5))
    log(f"phase 2: three_nn_interpolate (grouped) over one deformable request's {len(timed)} calls, in turns: "
        f"graph replay {turns['graph'][0]:.4f} ms (library chain {turns['graph'][1]:.4f} ms), host loop "
        f"{turns['loop'][0]:.4f} ms ({turns['loop'][1]:.4f} ms); each pair {json.dumps(turns['pairs'])}")
    t = {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
         "plain_ms": cuda_ms(lambda: [ops.three_nn_interpolate_grouped_plain(*a) for a in timed], 3),
         "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1]}
    # pos, the offsets, the known points and v read once; out, idx and w
    # written once; the search ranks every (query, known) pair of each
    # group, the sum 5 operations an output element
    n_ops = sum(B * (gr * S * M * OPS_PAIR_ONE_WAY + S * gr * C * OPS_INTERP_ELEM) for gr, S, M, C in calls)
    nbytes = sum(B * (S * 12 + gr * S * 12 + M * 12 + M * gr * C * 4 + S * gr * C * 4 + gr * S * 3 * (8 + 4))
                 for gr, S, M, C in calls)
    return 0.0, t, n_ops, nbytes


def time_grouped_gather(calls, k: int, g, dev) -> dict:
    """``nn.local_attention.grouped_deform_gather`` over one deformable
    request's calls ``calls`` ((batch, (groups, N k, M, group width))): its
    forward (no gradient, as a request runs it) and its forward with the
    gradient in v (as a train step takes it), each by graph replay and by
    host loop, in turns (forward, backward, backward, forward). One group
    is 'deform_graph''s call, with its offsets scaled by the region's box.
    Its signature is the parent tree's too, so a copy of this script beside
    an older tree times that tree's gather in the same call."""
    from imgadapointr_tpu_torch.nn import layers as port_layers
    from imgadapointr_tpu_torch.nn import local_attention as port_local

    timed = []
    for b, (groups, S, M, cg) in calls:
        C, N = groups * cg, S // k
        net = port_local.offset_net(2 * cg, C)
        port_layers.init_weights_(net, g)
        timed.append((net.to(dev), torch.randn(b, N, C, generator=g).to(dev),
                      torch.randn(b, M, C, generator=g).to(dev).requires_grad_(),
                      torch.randn(b, N, k, C, generator=g).to(dev), torch.randn(b, N, k, 3, generator=g).to(dev),
                      torch.randn(b, M, 3, generator=g).to(dev), groups, groups == 1))
    cots = [torch.randn(b, S // k, k, groups * cg, generator=g).to(dev) for b, (groups, S, M, cg) in calls]

    def forward():
        with torch.no_grad():
            for a in timed:
                port_local.grouped_deform_gather(*a)

    def forward_backward():
        for a, cot in zip(timed, cots):
            torch.autograd.grad(port_local.grouped_deform_gather(*a), a[2], cot)

    out = {}
    for how, timer in (("", graph_ms), ("_loop", cuda_ms)):
        f1 = timer(forward, 20)
        fb = [timer(forward_backward, 10) for _ in range(2)]
        f2 = timer(forward, 20)
        out[f"forward{how}_ms"], out[f"forward_backward{how}_ms"] = (f1 + f2) / 2, sum(fb) / 2
        out.setdefault("pairs", {})[how.strip("_") or "graph"] = [f1, *fb, f2]
    log(f"phase 2: grouped_deform_gather over one deformable request's {len(calls)} calls, in turns: "
        + json.dumps(out))
    return out


def lattice(g, b, n, dev):
    """Points k/64 with integer |k| <= 64: bf16-exact coordinates, so every
    product and sum of the matmul form is exact in float32 in any order."""
    return (torch.randint(-64, 65, (b, n, 3), generator=g).float() / 64).to(dev)


def mxu_plain_dist(q, r, idx, q_is_x: bool):
    """d~ of each point of q and its pick r[idx] in the plain version's
    arithmetic (``ops.chamfer.nn_argmin_bidir_mxu_plain``: x in the x role),
    and the pair's |x|^2 + |y|^2."""
    rg = torch.gather(r, 1, idx[..., None].expand(-1, -1, 3))
    x, y = (q, rg) if q_is_x else (rg, q)
    xh, xl, xs = chamfer._mxu_split(x)
    yh, yl, ys = chamfer._mxu_split(y)

    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    return (xs - 2.0 * ((dot(xh, yh) + dot(xh, yl)) + dot(xl, yh))) + ys, xs + ys


def mxu_band(x, y, i1, i2, p1, p2) -> dict:
    """The matmul-form kernel's indices (i1, i2) against the plain
    version's (p1, p2) on the same clouds: the share of equal indices in
    each direction; ``gap``, the largest excess of the kernel's pick over
    the plain version's in the plain version's own arithmetic, beyond the
    key's truncation (``MXU_TRUNC`` of |d~|), over the pair's |x|^2 +
    |y|^2; ``negative_picks``, the plain version's picks whose d~ is below
    zero (the form's cancellation, where the key's order of negative values
    decides); and, recomputed exactly from the indices in float64, the
    largest sqrt-abs difference of a selected distance, that pick's gap
    (``sqrt_abs_pick_gap``: the form cannot resolve distances closer than
    its own error, so a tie in its arithmetic may swap two candidates whose
    true distances differ by that much), and the CD-L1 and CD-L2 x1000
    differences; each also against the exact kernel's indices, for the
    record."""
    e1, e2 = ops.nn_bidir_argmin(x, y)
    xd, yd = x.double(), y.double()

    def sel(q, r, i):
        return ((q - torch.gather(r, 1, i[..., None].expand(-1, -1, 3))) ** 2).sum(-1)

    def against(a1, a2, b1, b2):
        d1, d2, t1, t2 = sel(xd, yd, a1), sel(yd, xd, a2), sel(xd, yd, b1), sel(yd, xd, b2)
        cd_l1 = lambda u, v: float((u.sqrt().mean() + v.sqrt().mean()) / 2 * 1000)  # noqa: E731
        cd_l2 = lambda u, v: float((u.mean() + v.mean()) * 1000)  # noqa: E731
        return {"equal_1": float((a1 == b1).double().mean()), "equal_2": float((a2 == b2).double().mean()),
                "sqrt_abs": max(float((d1.sqrt() - t1.sqrt()).abs().max()), float((d2.sqrt() - t2.sqrt()).abs().max())),
                "cd_l1_x1000": abs(cd_l1(d1, d2) - cd_l1(t1, t2)), "cd_l2_x1000": abs(cd_l2(d1, d2) - cd_l2(t1, t2))}

    out = {"kernel_vs_plain": against(i1, i2, p1, p2), "kernel_vs_exact": against(i1, i2, e1, e2),
           "plain_vs_exact": against(p1, p2, e1, e2)}
    gap, negative, worst = 0.0, 0, (-1.0, 0.0)
    for q, r, a, b, q_is_x in ((x, y, i1, p1, True), (y, x, i2, p2, False)):
        dk, scale = mxu_plain_dist(q, r, a, q_is_x)
        dp, _ = mxu_plain_dist(q, r, b, q_is_x)
        excess = (dk - dp - MXU_TRUNC * dp.abs()) / scale
        gap = max(gap, float(excess.max()))
        negative += int((dp < 0).sum())
        qd, rd = q.double(), r.double()
        sq = (sel(qd, rd, a).sqrt() - sel(qd, rd, b).sqrt()).abs().flatten()
        k = int(sq.argmax())
        worst = max(worst, (float(sq[k]), float(((dk - dp) / scale).flatten()[k])))
    out["kernel_vs_plain"].update(gap=gap, negative_picks=negative, sqrt_abs_pick_gap=worst[1])
    return out


def check_mxu(calls, extra, g, dev):
    """The matmul-form bidirectional argmin at the eval suite's 16384 x
    16384 at batch B (timed) and a ragged shape. The tensor cores add its
    products in an order of their own, so it is held to its plain version,
    on random clouds and a dense sphere, through ``mxu_band``: at least
    99.9 % of the indices equal and CD-L1 and CD-L2 x1000 within 1e-3 of the
    plain version's (the JAX package's band, ``MXU_BAND``), and every pick
    within ``MXU_GAP`` of the plain version's in the plain version's
    arithmetic, beyond the key's truncation. The band's sqrt-abs leg is
    printed, against the plain version and against the exact kernel: on
    the dense 16384-point sphere the form cannot resolve near-coincident
    candidates (the lo x lo products it drops reach a few 1e-6 there, about
    (2e-3)^2), so a tie in its arithmetic may swap candidates that far
    apart in sqrt, and the
    plain version itself sits at the CD leg's edge against the exact
    kernel. On lattice clouds every sum is exact, so there the indices must
    equal the plain version's, ties and first index included. Library:
    ``cdist`` with ``use_mm_for_euclid_dist``, then argmin along both
    axes."""
    bands = {}
    for b, (N, M) in batched(calls, extra):
        lx, ly = lattice(g, b, N, dev), lattice(g, b, M, dev)
        i1, i2 = ops.nn_argmin_bidir_mxu(lx, ly)
        p1, p2 = ops.nn_argmin_bidir_mxu_plain(lx, ly)
        require(torch.equal(i1, p1) and torch.equal(i2, p2), f"nn_bidir_mxu lattice {b}x{N}x{M}: indices differ")
        for kind in ("random", "sphere"):
            if kind == "random":
                x, y = torch.randn(b, N, 3, generator=g).to(dev), torch.randn(b, M, 3, generator=g).to(dev)
            else:
                x, y = sphere(g, b, N, dev), sphere(g, b, M, dev)
            i1, i2 = ops.nn_argmin_bidir_mxu(x, y)
            p1, p2 = ops.nn_argmin_bidir_mxu_plain(x, y)
            band = bands[f"{kind} {b}x{N}x{M}"] = mxu_band(x, y, i1, i2, p1, p2)
            k = band["kernel_vs_plain"]
            require(min(k["equal_1"], k["equal_2"]) >= MXU_BAND["equal"] and k["gap"] <= MXU_GAP
                    and max(k["cd_l1_x1000"], k["cd_l2_x1000"]) < MXU_BAND["cd_x1000"],
                    f"nn_bidir_mxu {kind} {b}x{N}x{M}: outside the band of its plain version: {k}")
    log("phase 2: nn_bidir_mxu band against the plain version (and each against the exact kernel): "
        + json.dumps(bands))
    base = lattice(g, 2, 3000, dev)  # every lattice point twice, half a cloud apart: the first copy wins
    dup, ly = torch.cat([base, base], 1), lattice(g, 2, 5000, dev)
    i1, i2 = ops.nn_argmin_bidir_mxu(ly, dup)
    p1, p2 = ops.nn_argmin_bidir_mxu_plain(ly, dup)
    require(torch.equal(i1, p1) and torch.equal(i2, p2) and bool((i1 < 3000).all()),
            "nn_bidir_mxu duplicated lattice: indices differ or a second copy won")
    (N, M), = calls
    same = torch.randn(2, N, 3, generator=g).to(dev)
    i1, i2 = ops.nn_argmin_bidir_mxu(same, same.clone())
    ident = torch.arange(N, device=dev).expand(2, N)
    share = min(float((i1 == ident).double().mean()), float((i2 == ident).double().mean()))
    require(share >= MXU_BAND["equal"], f"nn_bidir_mxu identical clouds: {share} of the indices are the identity")
    j1, _ = ops.nn_argmin_bidir_mxu(same, torch.cat([same, same], 1))
    require(bool((j1 < N).all()), "nn_bidir_mxu duplicated cloud: a second copy won")
    t = time_mxu(N, M, g, dev)
    t["more"]["identical_share"] = share
    n_ops = {PEAK_BF16_TC: B * N * M * OPS_PAIR_MXU_TC, PEAK_F32: B * N * M * OPS_PAIR_MXU_F32}
    return 0.0, t, n_ops, B * (N + M) * 12 + B * (N + M) * 8


def time_mxu(N: int, M: int, g, dev) -> dict:
    """The matmul-form argmin at B x N x M on dense spheres, by graph replay
    and host loop in turns with ``cdist`` (``use_mm_for_euclid_dist``) and
    argmins, and the exact kernel's replay time in the same call. Public
    ops only, so it times an older tree too."""
    x, y = sphere(g, B, N, dev), sphere(g, B, M, dev)

    def library():
        d = torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")
        return d.argmin(-1), d.argmin(1)

    turns = in_turns(lambda: ops.nn_argmin_bidir_mxu(x, y), library, reps=(10, 3))
    exact = graph_ms(lambda: ops.nn_bidir_argmin(x, y), 10)
    log(f"phase 2: nn_bidir_mxu at {B}x{N}x{M}, in turns: graph replay {turns['graph'][0]:.4f} ms (cdist mm + "
        f"argmins {turns['graph'][1]:.4f} ms), host loop {turns['loop'][0]:.4f} ms; the exact kernel "
        f"{exact:.4f} ms by replay in the same call; each pair {json.dumps(turns['pairs'])}")
    return {"ms": turns["graph"][0], "loop_ms": turns["loop"][0],
            "plain_ms": cuda_ms(lambda: ops.nn_argmin_bidir_mxu_plain(x, y), 1),
            "library_ms": turns["graph"][1], "library_loop_ms": turns["loop"][1],
            "more": {"exact_kernel_ms": exact}}


def mxu_hmma(lib_path) -> int:
    """HMMA instructions in the matmul-form kernel's SASS (``cuobjdump
    -sass`` on the built library)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True, capture_output=True, text=True).stdout
    return sum(sec.count("HMMA") for sec in sass.split("Function : ")[1:]
               if "nn_bidir_mxu_kernel" in sec.split(None, 1)[0])


# ------------------------------------------------------------- phase 3 path


def make_requests(cfg, seed: int, n_requests: int, b: int = B) -> list:
    """``n_requests`` requests of ``b`` synthetic samples for ``cfg``'s
    model: dicts of stacked numpy arrays, the model's inputs (partial cloud,
    and an image and a class one-hot where it takes them) and ``gt`` (of
    ``num_points``, else ``N_GT`` points)."""
    data = SyntheticPCN({"N_POINTS": int(cfg.get("num_points", N_GT)), "N_PARTIAL": N_PARTIAL,
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
    n_fine, nq = fine_points(cfg), int(cfg.num_query)
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


def run_train_steps(runner, batches, calls, what: str, phase: str, steps: int = TRAIN_STEPS):
    """1 warm-up and ``steps`` timed steps of ``runner`` on ``batches``
    (the loader's, in order), their losses finite and their launches the
    table ``calls``; returns (launch counts, step seconds, peak bytes
    allocated)."""
    secs, _ = timed_step(runner, batches[0], 0.0)  # warm-up (cuBLAS handles, caches)
    log(f"{phase}: warm-up step {secs * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for i, batch in enumerate(batches[1:1 + steps]):
        secs, m = timed_step(runner, batch, (i + 1) / len(batches))
        times.append(secs)
        require(all(np.isfinite(v) for v in m.values()), f"{phase} step {i}: non-finite {m}")
        log(f"{phase}: step {i}: {secs * 1e3:.1f} ms; sparse {m['sparse_loss']:.5f} dense "
            f"{m['dense_loss']:.5f} grad norm {m['grad_norm']:.4f} lr {m['lr']:.3e}")
    counts = check_launches(what, calls, steps)
    peak = torch.cuda.max_memory_allocated()
    log(f"{phase}: median step {statistics.median(times) * 1e3:.1f} ms at batch {len(batches[0]['gt'])}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
        f"{json.dumps({k: v // steps for k, v in counts.items()})}")
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
    determinism = step_determinism(runner, batch, 0.9)
    summary = {"batch": B_TRAIN, "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in prof.items() if k != "top"},
               "emd": {k: emd[k] for k in ("emd_ms", "top2_launches", "iterations", "converged",
                                           "top2_in_path_ms", "device_busy_ms")},
               "mxu_eval": mxu, "step_determinism": determinism}
    return counts, summary


def step_determinism(runner, batch, epoch_f: float, phase: str = "phase 4", params: bool = False) -> dict:
    """One train step's gradients (forward in train mode, the model's loss,
    backward; no optimizer step) taken twice from the same state, batch and
    jitter noise: whether the predicted clouds, the loss's gradient with
    respect to them and every parameter's gradient come out bit-equal. The
    clouds' gradient passes only through the chamfer backward
    (``nn_distance``'s and the scatter-add's kernels, both deterministic),
    so it is required bit-equal; and, isolated from the forward, the loss's
    gradient on the first run's clouds is taken twice more and required
    bit-equal. With ``params`` (``AdaPoinTr-deform``, whose 3-NN VJP is the
    deterministic ``dfeats``) every parameter's gradient is required
    bit-equal too, else read. The model's state and the runner's generator
    are restored."""
    model = runner.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = runner.generator.get_state()
    batch = runner._to_device(batch)
    noise = torch.randn(batch["gt"].shape[0], DENOISE, 3, generator=torch.Generator().manual_seed(7)).to(batch["gt"].device)
    runs = []
    for _ in range(2):
        model.load_state_dict(state)
        runner.generator.set_state(gen)
        model.train()
        model.zero_grad(set_to_none=True)
        ret = model(*runner._inputs(batch), bn_momentum=runner.bnm_sched(epoch_f), generator=runner.generator,
                    noise=noise)
        sparse, dense = model.loss(ret, batch["gt"], epoch_f)
        clouds = [ret[0], ret[2], ret[3]]  # pred_coarse, denoised_fine, pred_fine
        cloud_grads = torch.autograd.grad(sparse + dense, clouds, retain_graph=True)
        (sparse + dense).backward()
        runs.append(([c.detach().clone() for c in clouds], [g.clone() for g in cloud_grads],
                     {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
                     [t.detach().clone() for t in ret]))
    model.load_state_dict(state)
    runner.generator.set_state(gen)
    model.zero_grad(set_to_none=True)
    (c1, g1, p1, ret1), (c2, g2, p2, _) = runs
    # the loss's gradient on run 1's clouds, twice, with the forward held fixed
    iso = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(i in (0, 2, 3)) for i, t in enumerate(ret1)]
        sparse, dense = model.loss(tuple(leaves), batch["gt"], epoch_f)
        iso.append(torch.autograd.grad(sparse + dense, [leaves[i] for i in (0, 2, 3)]))
    differ = sorted(n for n in p1 if not torch.equal(p1[n], p2[n]))
    out = {"clouds_equal": all(torch.equal(a, b) for a, b in zip(c1, c2)),
           "cloud_grads_equal": all(torch.equal(a, b) for a, b in zip(g1, g2)),
           "cloud_grads_equal_fixed_forward": all(torch.equal(a, b) for a, b in zip(*iso)),
           "param_grads_equal": not differ, "param_grads_differing": len(differ), "params_with_grad": len(p1),
           "first_differing": differ[:5],
           "max_abs_param_grad_diff": max((float((p1[n] - p2[n]).abs().max()) for n in differ), default=0.0)}
    log(f"{phase}: one train step's gradients twice from the same state: " + json.dumps(out))
    require(out["cloud_grads_equal_fixed_forward"], "the chamfer loss's gradient on fixed clouds differs between runs")
    require(out["cloud_grads_equal"] or not out["clouds_equal"],
            "the chamfer loss's gradient with respect to equal predicted clouds differs between runs")
    if params:
        require(out["clouds_equal"] and out["param_grads_equal"],
                f"{phase}: {len(differ)} parameters' gradients differ between two runs from the same state "
                f"(first {differ[:5]})")
    return out


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


def point_matching(card_pts, cpu_pts):
    """Each card point's nearest CPU point, per batch element (float64):
    (pi (B, N): card point i is CPU point pi[b, i], the largest distance of
    a match, whether pi is a permutation, how many points it moves)."""
    d = torch.cdist(card_pts.double(), cpu_pts.double())
    dist, pi = d.min(dim=-1)
    perm = all(int(row.unique().numel()) == row.numel() for row in pi)
    moved = int((pi != torch.arange(pi.shape[1])).sum())
    return pi, float(dist.max()), perm, moved


def relabel(pi, idx, scores):
    """The card's picks and scores of one ``top_k_indices`` call in the CPU's
    point labels (``pi`` from :func:`point_matching`): scores (B, N, N) of
    point pairs with picks (B, N, k) of points, or scores (B, N) of points
    with picks (B, M)."""
    bidx = torch.arange(pi.shape[0])[:, None]
    idx = torch.gather(pi, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    if scores.dim() == 2:
        out = torch.empty_like(scores)
        out[bidx, pi] = scores
        return idx, out
    rows, out_idx = torch.empty_like(scores), torch.empty_like(idx)
    rows[bidx, pi] = scores
    out = torch.empty_like(scores)
    out[bidx[:, :, None], torch.arange(scores.shape[1])[None, :, None], pi[:, None, :]] = rows
    out_idx[bidx, pi] = idx
    return out_idx, out


def pick_gaps(card_idx, cpu_idx, card_scores, cpu_scores) -> dict:
    """How far apart two devices' differing picks of one ``top_k_indices``
    call are, read in the CPU's scores taken in float64: at each position
    where the card picked another index than the CPU, the difference of the
    CPU's scores of the two picks, relative to the row's largest |score| (as ``sqrt_abs_pick_gap``
    reads the matmul-form argmin's picks); the largest such gap, and how
    many exceed ``PICK_GAP_ULPS`` float32 ulps of that magnitude. Beside
    them, how far the two devices' scores themselves are apart (the largest
    |card - CPU| relative to the row's largest |score|), which a pick that
    is no near-tie of the CPU's scores can only come from."""
    cpu64, card64 = cpu_scores.double(), card_scores.double()
    scale = cpu64.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    differ = card_idx != cpu_idx
    gap = (cpu64.gather(-1, cpu_idx) - cpu64.gather(-1, card_idx)) / scale
    gap = gap[differ]
    ulp = 2.0 ** -23
    return {"differ": int(differ.sum()), "of": int(differ.numel()),
            "max_gap_over_row_max": float(gap.abs().max()) if gap.numel() else 0.0,
            "above_ulps": int((gap.abs() > PICK_GAP_ULPS * ulp).sum()),
            "max_score_diff_over_row_max": float(((card64 - cpu64).abs() / scale).max())}


def gdanet_readings(picks, scores, points) -> dict:
    """GDANet's selections of one step on the card and on the CPU (each
    device's ``top_k_indices`` picks and scores in call order, and its input
    points and normals): how many differ, their gaps position by position
    (:func:`pick_gaps`), how the two input clouds match (:func:`point_matching`),
    how far the normals it was handed are apart in input order (they are the
    reference's reshaped buffer, so a point's normal depends on the order of
    the points), and the gaps again with the card's picks and scores in the
    CPU's point labels (:func:`relabel`)."""
    require(len(picks["cuda"]) == len(picks["cpu"]), "GDANet's selections were not all recorded")
    require(len(points["cuda"]) == len(points["cpu"]) == 1, "GDANet's input was not recorded once")
    (card_pts, card_nrm), (cpu_pts, cpu_nrm) = points["cuda"][0], points["cpu"][0]
    pi, dist, perm, moved = point_matching(card_pts, cpu_pts)
    nrm = (card_nrm.double() - cpu_nrm.double()).abs().amax(dim=-1)
    calls = list(zip(picks["cuda"], picks["cpu"], scores["cuda"], scores["cpu"]))
    relabelled = []
    for i, ci, sc, cs in calls:
        ri, rs = relabel(pi, i, sc)
        relabelled.append(pick_gaps(ri, ci, rs, cs))
    return {"gdanet_selections": sum(a.numel() for a in picks["cpu"]),
            "gdanet_selections_differ": [int((a != b).sum()) for a, b in zip(picks["cuda"], picks["cpu"])],
            "gdanet_pick_gaps": [pick_gaps(*a) for a in calls],
            "gdanet_input": {"max_match_distance": dist, "is_permutation": perm, "points_moved": moved,
                             "points": int(pi.numel()), "normals_max_diff_in_order": float(nrm.max()),
                             "normals_apart_1e-3_in_order": int((nrm > 1e-3).sum())},
            "gdanet_pick_gaps_relabelled": relabelled}


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
    scores_seen = {"cuda": [], "cpu": []}
    points_in = {"cuda": [], "cpu": []}
    original, forward = port_gdanet.top_k_indices, port_gdanet.GDANet.forward

    def record(scores, k):
        idx = original(scores, k)
        picks[scores.device.type].append(idx.cpu())
        scores_seen[scores.device.type].append(scores.detach().cpu())
        return idx

    def record_points(self, coor, normals, *args, **kwargs):
        points_in[coor.device.type].append((coor.detach().cpu(), normals.detach().cpu()))
        return forward(self, coor, normals, *args, **kwargs)

    port_gdanet.top_k_indices = record
    port_gdanet.GDANet.forward = record_points
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
        port_gdanet.top_k_indices, port_gdanet.GDANet.forward = original, forward
    if picks["cpu"]:
        out.update(gdanet_readings(picks, scores_seen, points_in))
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
    gaps, relabelled = agree.pop("gdanet_pick_gaps"), agree.pop("gdanet_pick_gaps_relabelled")
    log("phase 6: GDANet's differing train-step selections, card vs CPU, per top_k_indices call: "
        + json.dumps(gaps))
    log("phase 6: GDANet's input points, card against CPU: " + json.dumps(agree["gdanet_input"])
        + "; the selections in the CPU's point labels: " + json.dumps(relabelled))
    for what, gs in (("position by position", gaps), ("in the CPU's point labels", relabelled)):
        log(f"phase 6: {what}: largest gap of a differing pick "
            f"{max(x['max_gap_over_row_max'] for x in gs):.3e} of the row's largest |score| in the CPU's "
            f"scores; picks past {PICK_GAP_ULPS} float32 ulps {sum(x['above_ulps'] for x in gs)} of "
            f"{sum(x['differ'] for x in gs)} differing; the devices' scores apart by up to "
            f"{max(x['max_score_diff_over_row_max'] for x in gs):.3e} of it")
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
    determinism = step_determinism(runner, batches[1 + TRAIN_STEPS], 0.9, "phase 7", params=True)
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
               "card_vs_cpu_step": {k: step_agree[k] for k in ("total_loss_rel_diff", "grad_norm_rel_diff")},
               "step_determinism": determinism}
    return counts, summary


# ------------------------------------------------------------ phase 11 path


OPTION_RATE = 0.1
LEGACY_TOKENS, LEGACY_MEMORY = 512, 256  # the flagship's queries and encoder centres


def options_config(rate: float = OPTION_RATE):
    """The options flagship: ``cfgs/PCN_models/AdaPoinTr.yaml`` with the
    ``pn`` encoder, the ``fold`` head (64 points a query: 2048 -> 512 +
    32768), 'onebyone' in the encoder and both decoder halves, LayerScale
    (``init_values`` 1e-5) and ``rate`` for dropout, attention dropout and
    DropPath; every width as shipped."""
    config = cfg_from_yaml_file(CONFIG)
    m = config.model
    m.encoder_type, m.decoder_type = "pn", "fold"
    m.encoder_config.combine_style = "onebyone"
    m.decoder_config.self_attn_combine_style = m.decoder_config.cross_attn_combine_style = "onebyone"
    for c in (m.encoder_config, m.decoder_config):
        c.init_values = 1e-5
        c.drop_rate = c.attn_drop_rate = c.drop_path_rate = rate
    return config


def options_deform_config():
    """``deform_config()`` with 'onebyone' everywhere, LayerScale and
    DropPath at 0.1 (dropout 0): the grouped 3-NN and ``dfeats`` under the
    two-branch blocks."""
    config = deform_config()
    m = config.model
    m.encoder_config.combine_style = "onebyone"
    m.decoder_config.self_attn_combine_style = m.decoder_config.cross_attn_combine_style = "onebyone"
    for c in (m.encoder_config, m.decoder_config):
        c.init_values, c.drop_path_rate = 1e-5, OPTION_RATE
    return config


def kept_shares(runner, batch, epoch_f: float) -> list:
    """One train step's dropout and DropPath masks, recorded as the model
    draws them: each site's (entries, kept share)."""
    original, seen = port_layers.keep_mask, []

    def record(shape, keep, generator, device):
        mask = original(shape, keep, generator, device)
        seen.append((mask.numel(), float(mask.float().mean()), keep))
        return mask

    port_layers.keep_mask = record
    try:
        timed_step(runner, batch, epoch_f)
    finally:
        port_layers.keep_mask = original
    return seen


def options_flagship(seed: int, dev, card: str, workdir: str):
    """Phase 11a: the options flagship's requests, steps, validate, card vs
    CPU (rates 0), determinism and kept shares (rates 0.1)."""
    config = options_config()
    cfg = config.model
    model = build_model(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 11: the options flagship built, {n_params} parameters; {B}x{N_PARTIAL} -> "
        f"{B}x{fine_points(cfg)} a request")
    batches = make_requests(cfg, seed, REQUESTS + 1)
    serve(model, cfg, batches[:1], dev)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    secs, scores = serve(model, cfg, batches[1:], dev)
    counts = {"options_request": check_launches("the options requests", dict(
        request_calls(cfg), scatter_add_rows=[], nn_one_direction=[]), REQUESTS)}
    req_peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: serve(model, cfg, [batches[1]], dev)[0][0])
    log(f"phase 11: options requests {[round(t * 1e3, 1) for t in secs]} ms (median "
        f"{statistics.median(secs) * 1e3:.1f}) on {card}; CD-L1 {[round(s[1], 4) for s in scores]}; peak "
        f"{req_peak / 2**30:.2f} GiB; launches per request "
        f"{json.dumps({k: v // REQUESTS for k, v in counts['options_request'].items()})}")
    log("phase 11: one profiled options request: " + json.dumps(prof))
    # batch 2 against the CPU at rates 0 (eval ignores them), the ranking layer scaled on both
    cpu_model = build_model(cfg, device="cpu", seed=seed)
    for m in (model, cpu_model):
        with torch.no_grad():
            m.base_model.query_ranking[4].weight.mul_(1000.0)
    agree = cpu_agreement(model, cpu_model, {k: v[:2] for k, v in batches[1].items()}, dev)
    log("phase 11: options request, card vs CPU at batch 2: " + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "the options flagship: the card's clouds disagree with the CPU's")
    del model, cpu_model

    swap_synthetic(config, train_len=B_TRAIN * (TRAIN_STEPS + 3))
    config.dataset.train.others.bs = B_TRAIN
    config.dataset.val.LENGTH, config.dataset.val.others.bs = EVAL_CLOUDS, 1
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, val_loader = dataset_builder(args, config.dataset.val)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    require(len(runner.model._stochastic) > 0, "the options flagship has no dropout layer")
    batches = [b for _, _, b in train_loader]
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    train, times, peak = run_train_steps(runner, batches, train_step_calls(cfg),
                                         "the options train steps", "phase 11")
    counts["options_train"] = train
    check_trained(runner.model, before)
    step_prof = profile_run(lambda: timed_step(runner, batches[1 + TRAIN_STEPS], 0.9)[0])
    log("phase 11: one profiled options train step: " + json.dumps(step_prof))
    determinism = step_determinism(runner, batches[1 + TRAIN_STEPS], 0.9, "phase 11", params=True)
    shares = kept_shares(runner, batches[2 + TRAIN_STEPS], 0.95)
    bands = [abs(share - keep) / (6 * (keep * (1 - keep) / n) ** 0.5) for n, share, keep in shares]
    log(f"phase 11: {len(shares)} dropout / DropPath masks in one step; kept shares "
        f"{min(s for _, s, _ in shares):.4f}-{max(s for _, s, _ in shares):.4f}, the largest distance from "
        f"0.9 {max(bands):.3f} of its 6-sigma band")
    require(len(shares) > 0 and max(bands) <= 1.0, "a dropout site's kept share is outside its 6-sigma band")
    _build.reset_launches()
    metrics = port_runner.validate(runner, val_loader, 0, "silent")
    counts["options_validate"] = check_launches("the options validate", eval_calls(cfg, "validate"), EVAL_CLOUDS)
    require(all(np.isfinite(v) for v in metrics.state_dict().values()), f"validate: {metrics}")
    log(f"phase 11: validate on {EVAL_CLOUDS} clouds of 32768 against 16384 points: {metrics}")
    del runner, batches
    torch.cuda.empty_cache()
    step_agree = card_vs_cpu_step(options_config(0.0), seed, workdir)
    log("phase 11: card vs CPU, one options step at batch 2, rates 0: " + json.dumps(step_agree))
    summary = {"request_batch": B, "request_ms": [t * 1e3 for t in secs],
               "median_request_ms": statistics.median(secs) * 1e3,
               "request_peak_gib": req_peak / 2**30,
               "profiled_request": {k: v for k, v in prof.items() if k != "top"},
               "card_vs_cpu_request": {k: agree[k] for k in ("coarse_matched", "fine_matched")},
               "train_batch": B_TRAIN, "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in step_prof.items() if k != "top"},
               "card_vs_cpu_step": {k: step_agree[k] for k in ("total_loss_rel_diff", "grad_norm_rel_diff")},
               "step_determinism": determinism, "dropout_sites": len(shares),
               "kept_share_worst_band": max(bands)}
    return counts, summary


def options_deform(seed: int, dev, workdir: str):
    """Phase 11b: ``options_deform_config()``'s train steps at B_TRAIN and
    their determinism."""
    config = options_deform_config()
    swap_synthetic(config, train_len=B_TRAIN * (TRAIN_STEPS + 2))
    config.dataset.train.others.bs = B_TRAIN
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    batches = [b for _, _, b in train_loader]
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    train, times, peak = run_train_steps(runner, batches, train_step_calls(config.model),
                                         "the deformable options train steps", "phase 11")
    check_trained(runner.model, before, dead=("query_ranking", "encoder.norm", "linear_offset", "proj_v_off"))
    prof = profile_run(lambda: timed_step(runner, batches[1 + TRAIN_STEPS], 0.9)[0])
    log("phase 11: one profiled deformable options train step: " + json.dumps(prof))
    determinism = step_determinism(runner, batches[1 + TRAIN_STEPS], 0.9, "phase 11", params=True)
    del runner
    torch.cuda.empty_cache()
    return {"options_deform_train": train}, {"median_step_ms": statistics.median(times) * 1e3,
                                             "max_memory_allocated_gib": peak / 2**30,
                                             "profiled_step": {k: v for k, v in prof.items() if k != "top"},
                                             "step_determinism": determinism}


def card_vs_cpu_module(name: str, module, inputs: list, dev) -> dict:
    """``module``'s forward and backward (``sum(sin(out))``) on the card
    against the same module on the CPU, same weights and inputs: the loss
    within 1e-4 relative and the gradients (inputs and parameters) within
    1e-3 of their norm, the step's bands."""
    runs = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        mod = copy.deepcopy(module).to(device)
        xs = [x.detach().to(device, copy=True).requires_grad_(i % 2 == 0) for i, x in enumerate(inputs)]
        out = mod(*xs)
        loss = torch.sin(out).sum()
        loss.backward()
        grads = [x.grad for x in xs if x.grad is not None] + [p.grad for p in mod.parameters() if p.grad is not None]
        runs[key] = (float(loss.detach()), [g.detach().cpu() for g in grads], out.detach().cpu())
    (lc, gc, oc), (lp, gp, op) = runs["card"], runs["cpu"]
    norm = sum(float(g.square().sum()) for g in gp) ** 0.5
    diff = sum(float((a - b).square().sum()) for a, b in zip(gc, gp)) ** 0.5
    out = {"loss_rel_diff": abs(lc - lp) / abs(lp), "grad_diff_over_norm": diff / norm,
           "out_max_abs_diff": float((oc - op).abs().max()), "out_max_abs": float(op.abs().max())}
    require(len(gc) == len(gp) and out["loss_rel_diff"] <= 1e-4 and out["grad_diff_over_norm"] <= 1e-3,
            f"{name}: card vs CPU {out}")
    return out


def modules_phase(seed: int, dev) -> dict:
    """Phase 11c: the standalone modules at the flagship's widths (dim 384,
    6 heads, batch B), card against CPU: the seven legacy blocks on
    ``LEGACY_TOKENS`` tokens (decoder blocks over ``LEGACY_MEMORY``),
    ``ImprovedDeformableLocalCrossAttention`` on the decoder's cross shapes
    (k 8, n_group 2), ResNet50 and ConvNeXt-small on B x 224² images (TF32
    off; outputs within ``IMAGE_BAND`` of their largest magnitude),
    ``ball_query`` on lattice clouds (indices equal)."""
    g = torch.Generator().manual_seed(seed)
    dim, heads = 384, 6
    q, v = torch.randn(B, LEGACY_TOKENS, dim, generator=g), torch.randn(B, LEGACY_MEMORY, dim, generator=g)
    q_pos, v_pos = sphere(g, B, LEGACY_TOKENS, "cpu"), sphere(g, B, LEGACY_MEMORY, "cpu")
    out = {}
    for cls in port_legacy.LEGACY_BLOCKS:
        kw = {} if cls is port_legacy.GraphConvBlock else {"num_heads": heads, "qkv_bias": True}
        # LayerScale at 1, so that each branch counts in the output in full
        mod = init_weights_(cls(dim, init_values=1.0, **kw), torch.Generator().manual_seed(seed)).eval()
        decoder = cls in (port_legacy.DecoderBlock, port_legacy.DeformableAttnDecoderBlock,
                          port_legacy.GraphConvDecoderBlock)
        # inputs alternate feature, position: gradients flow into the features
        args = [q, q_pos, v, v_pos] if decoder else [q, q_pos]
        out[cls.__name__] = card_vs_cpu_module(cls.__name__, _DecoderCall(mod) if decoder else mod, args, dev)
    attn = init_weights_(port_la.ImprovedDeformableLocalCrossAttention(dim, heads, True, k=8, n_group=2),
                         torch.Generator().manual_seed(seed)).eval()
    out["ImprovedDeformableLocalCrossAttention"] = card_vs_cpu_module(
        "ImprovedDeformableLocalCrossAttention", _CrossCall(attn), [q, q_pos, v, v_pos], dev)
    log("phase 11: standalone modules, card vs CPU: " + json.dumps(out))
    img = torch.rand(B, 224, 224, 3, generator=g)
    for name, enc in (("ResNet50Encoder", port_image.ResNet50Encoder()),
                      ("ConvNextEncoder", port_image.ConvNextEncoder())):
        init_weights_(enc, torch.Generator().manual_seed(seed)).eval()
        with torch.no_grad():
            want = enc(img)
            got = copy.deepcopy(enc).to(dev)(img.to(dev)).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        out[name] = {"shape": list(got.shape), "max_abs_diff_over_max": rel}
        log(f"phase 11: {name} at {B}x224x224, card vs CPU: {json.dumps(out[name])}")
        require(rel <= IMAGE_BAND, f"{name}: card vs CPU {rel:.3e} of the output's scale")
    lat = (torch.randint(-64, 65, (B, N_GT, 3), generator=g) / 64).float()
    qs = lat[:, :LEGACY_TOKENS].contiguous()
    want = ops.ball_query(0.1, 32, lat, qs)
    got = ops.ball_query(0.1, 32, lat.to(dev), qs.to(dev)).cpu()
    out["ball_query"] = {"queries": B * LEGACY_TOKENS, "points": N_GT, "equal": bool(torch.equal(got, want))}
    log("phase 11: ball_query on lattice clouds, card vs CPU: " + json.dumps(out["ball_query"]))
    require(out["ball_query"]["equal"], "ball_query: the card's indices differ from the CPU's")
    return out


class _DecoderCall(torch.nn.Module):
    """A decoder block called as (q, q_pos, v, v_pos)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, q, q_pos, v, v_pos):
        return self.block(q, v, q_pos, v_pos)


class _CrossCall(_DecoderCall):
    def forward(self, q, q_pos, v, v_pos):
        return self.block(q, q_pos, v=v, v_pos=v_pos)


def remat_check(seed: int, dev, workdir: str) -> dict:
    """Phase 11d: one superset train forward and backward at B_TRAIN (no
    optimizer step) without and with ``IMGADAPOINTR_ENABLE_SEG_REMAT``,
    from the same state, batch and noise: the loss bit-equal, every
    parameter's gradient within 1e-6 of its largest entry; the device busy
    time and the peak memory of each."""
    config = cfg_from_yaml_file(SUPERSET)
    swap_synthetic(config, train_len=B_TRAIN)
    config.dataset.train.others.bs = B_TRAIN
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    runner = port_runner.Runner(args, config, logger="silent")
    model = runner.model
    batch = runner._to_device(next(iter(train_loader))[2])
    noise = torch.randn(B_TRAIN, DENOISE, 3, generator=torch.Generator().manual_seed(seed)).to(dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    prev = os.environ.get("IMGADAPOINTR_ENABLE_SEG_REMAT")
    try:
        for flag in ("0", "1", "0", "1"):  # the second pair is measured
            os.environ["IMGADAPOINTR_ENABLE_SEG_REMAT"] = flag

            def run():
                model.load_state_dict(state)
                model.train().zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with deterministic_cudnn():
                    loss = sum(model.loss(model(*runner._inputs(batch), bn_momentum=0.1, noise=noise),
                                          batch["gt"], 0.0))
                    loss.backward()
                torch.cuda.synchronize()
                runs[flag] = (loss.detach().clone(), {n: p.grad.clone() for n, p in model.named_parameters()
                                                      if p.grad is not None})
                return time.perf_counter() - t0

            torch.cuda.reset_peak_memory_stats()
            run()
            peak = torch.cuda.max_memory_allocated()
            prof = profile_run(run)
            runs[flag] = runs[flag] + ({"peak_gib": peak / 2**30, "device_busy_ms": prof.get("device_busy_ms"),
                                        "wall_ms": prof.get("wall_ms"), "launches": prof.get("launches")},)
    finally:
        if prev is None:
            os.environ.pop("IMGADAPOINTR_ENABLE_SEG_REMAT", None)
        else:
            os.environ["IMGADAPOINTR_ENABLE_SEG_REMAT"] = prev
    (l0, g0, m0), (l1, g1, m1) = runs["0"], runs["1"]
    worst = max(float((g0[n] - g1[n]).abs().max() / g0[n].abs().max().clamp_min(1e-30)) for n in g0)
    out = {"loss_equal": bool(torch.equal(l0, l1)), "grad_worst_rel": worst, "off": m0, "on": m1}
    log("phase 11: the superset's step without and with IMGADAPOINTR_ENABLE_SEG_REMAT: " + json.dumps(out))
    require(out["loss_equal"] and g0.keys() == g1.keys() and worst <= 1e-6,
            "the GDANet remat changes the superset's step")
    del runner, model
    torch.cuda.empty_cache()
    return out


def options_phase(seed: int, dev, card: str):
    """Phase 11: the options no shipped config sets (a-d)."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts, flagship = options_flagship(seed, dev, card, workdir)
        deform_counts, deform = options_deform(seed, dev, workdir)
        counts.update(deform_counts)
        modules = modules_phase(seed, dev)
        remat = remat_check(seed, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return counts, {"flagship": flagship, "deform": deform, "modules": modules, "remat": remat}


# ------------------------------------------------------------ phase 8 path


PCN_TAXONOMIES = {"02958343": 112, "02691156": 16}  # car (the KITTI finetune's), airplane: train models
SHAPENET_TAXONOMIES = ("02691156", "02958343", "03001627", "04379243")


def root_paths(split_cfg, root: str) -> None:
    """Point a dataset split's ``data/...`` paths into ``root``, keeping the
    layout the config names."""
    for key in ("CATEGORY_FILE_PATH", "PARTIAL_POINTS_PATH", "COMPLETE_POINTS_PATH", "DATA_PATH", "PC_PATH"):
        if str(split_cfg.get(key, "")).startswith("data/"):
            split_cfg[key] = os.path.join(root, split_cfg[key][len("data/"):])


def write_pcn_tree(pcn_cfg, seed: int) -> dict:
    """A PCN tree in the layout of ``cfgs/dataset_configs/PCN.yaml`` (the
    config's own path patterns), written with the port's ``IO.put`` as
    binary ``.pcd``: ``PCN_TAXONOMIES`` train models with 8 renders, one
    val and one test model a taxonomy; complete clouds of 16384 points
    (smooth closed surfaces), partials of 1400-2700 points (one side of
    the surface, jittered). Returns the category file's entries."""
    rng = np.random.default_rng(seed)
    cats = [{"taxonomy_id": t, "taxonomy_name": t, "train": [f"{t}_m{i:03d}" for i in range(n)],
             "val": [f"{t}_v0"], "test": [f"{t}_t0"]} for t, n in PCN_TAXONOMIES.items()]
    os.makedirs(os.path.dirname(pcn_cfg.CATEGORY_FILE_PATH), exist_ok=True)
    with open(pcn_cfg.CATEGORY_FILE_PATH, "w") as f:
        json.dump(cats, f)
    n_points = int(pcn_cfg.N_POINTS)
    for dc in cats:
        for subset in ("train", "val", "test"):
            for m in dc[subset]:
                gt = _surface_points(rng, n_points)
                normal = rng.standard_normal(3)
                side = gt[gt @ normal > np.median(gt @ normal)]
                for r in range(int(pcn_cfg.N_RENDERINGS) if subset == "train" else 1):
                    pts = side[rng.integers(0, len(side), int(rng.integers(1400, 2700)))]
                    pts = pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)
                    path = pcn_cfg.PARTIAL_POINTS_PATH % (subset, dc["taxonomy_id"], m, r)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    IO.put(path, pts)
                path = pcn_cfg.COMPLETE_POINTS_PATH % (subset, dc["taxonomy_id"], m)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                IO.put(path, gt)
    return cats


def write_shapenet_tree(sn_cfg, n_train: int, n_test: int, seed: int) -> None:
    """A ShapeNet-55 tree in the layout of ``cfgs/dataset_configs/ShapeNet55.yaml``:
    ``train.txt`` / ``test.txt`` naming ``<taxonomy>-<model>.npy`` clouds of
    ``N_POINTS`` (8192) surface points, written with ``IO.put``."""
    rng = np.random.default_rng(seed)
    os.makedirs(sn_cfg.DATA_PATH, exist_ok=True)
    os.makedirs(sn_cfg.PC_PATH, exist_ok=True)
    for subset, n in (("train", n_train), ("test", n_test)):
        lines = [f"{SHAPENET_TAXONOMIES[i % len(SHAPENET_TAXONOMIES)]}-{subset}{i:04d}.npy" for i in range(n)]
        for line in lines:
            IO.put(os.path.join(sn_cfg.PC_PATH, line), _surface_points(rng, int(sn_cfg.N_POINTS)))
        with open(os.path.join(sn_cfg.DATA_PATH, f"{subset}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def merged(*tables) -> dict:
    """The kernel call tables of several parts of one run, concatenated."""
    out: dict = {}
    for table in tables:
        for k, v in table.items():
            out[k] = None if v is None or out.get(k, []) is None else out.get(k, []) + list(v)
    return out


def crop_calls(n: int) -> dict:
    """The ShapeNet-55 train crop's calls a step: the sort's gather, FPS to
    2048 and its gather."""
    return {"fps": [(n, N_PARTIAL)], "gather_rows": [(n, 3, n), (n, 3, N_PARTIAL)]}


def dropping_calls(n: int) -> dict:
    """The KITTI dropping's calls a step: FPS to ``min(n, 768)`` and its gather."""
    s = min(n, DROP_POINTS)
    return {"fps": [(n, s)], "gather_rows": [(n, 3, s)]}


def shapenet_test_calls(cfg, n: int, num_crop: int) -> dict:
    """One ShapeNet-55 test batch's calls: every crop's sort gather, FPS to
    2048 and its gather, then one eval request with the coarse cloud's
    chamfer over all crops (the F-Score from the same pass)."""
    return merged(eval_calls(cfg, "validate"),
                  {"fps": [(n - num_crop, N_PARTIAL)], "gather_rows": [(n, 3, n), (n - num_crop, 3, N_PARTIAL)]})


def recipe_args(seed: int, workdir: str, **kw):
    return types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, emd=True, experiment_path=workdir, **kw)


def loader_ms(loader, n: int = 3) -> float:
    """Host milliseconds a batch of ``loader`` (0 workers: the reader, its
    transforms and the collate in this process), over ``n`` batches."""
    t0 = time.perf_counter()
    for _ in itertools.islice(loader, n):
        pass
    return (time.perf_counter() - t0) / n * 1e3


def check_loader(dataset, dataset_cfg, seed: int) -> dict:
    """A smoke run of the loader's 2 worker processes on this machine's
    torch: its first two batches of epoch 1 against the same reader's
    samples made in this process with the JAX loader's order and seeds,
    equal bit for bit; then ``close`` stops the workers.
    (``tests/test_torch_data.py`` holds the loader to the JAX loader over
    two epochs and checks that the workers exit.)"""
    _, loader = dataset_builder(types.SimpleNamespace(seed=seed, num_workers=2, worker_mode="process"), dataset_cfg)
    loader.set_epoch(1)
    order, base, bs = loader.sampler.order(), base_seed(seed, 1), loader.batch_size
    try:
        for b, (taxonomy_ids, model_ids, batch) in enumerate(itertools.islice(loader, 2)):
            samples = [dataset.get(int(i), np.random.default_rng((base, int(i)))) for i in order[b * bs:(b + 1) * bs]]
            require(taxonomy_ids == [s[0] for s in samples] and model_ids == [s[1] for s in samples],
                    "the loader's order differs from the reader's")
            for k, v in batch.items():
                require(torch.equal(v, torch.from_numpy(np.stack([s[2][k] for s in samples]))),
                        f"the 2-worker loader's {k} differs from the reader's in this process")
    finally:
        loader.close()
    return {"batches": 2, "batch": bs, "workers": 2, "equal": True}


def timed_augment(runner, batch, epoch_f: float) -> float:
    """Seconds of one train augmentation of a batch on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.augment(batch, epoch_f)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def recipe_steps(runner, loader, calls, what: str) -> tuple:
    """1 warm-up and ``TRAIN_STEPS`` steps of ``runner`` on the loader's
    first batches (epoch 0) with the launch table ``calls``, the host time a
    batch of the loader, and one profiled step; returns (launch counts,
    summary, the batches)."""
    loader.set_epoch(0)
    ms_batch = loader_ms(loader)
    batches = [b for _, _, b in itertools.islice(loader, TRAIN_STEPS + 2)]
    require(len(batches) == TRAIN_STEPS + 2, f"{what}: {len(batches)} batches")
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    counts, times, peak = run_train_steps(runner, batches, calls, what, "phase 8")
    check_trained(runner.model, before)
    prof = profile_run(lambda: timed_step(runner, batches[1 + TRAIN_STEPS], 0.9)[0])
    log(f"phase 8: one profiled step of {what}: " + json.dumps(prof))
    summary = {"batch": len(batches[0]["gt"]), "step_ms": [t * 1e3 for t in times],
               "median_step_ms": statistics.median(times) * 1e3, "max_memory_allocated_gib": peak / 2**30,
               "loader_ms_per_batch": ms_batch,
               "profiled_step": {k: v for k, v in prof.items() if k != "top"}}
    return counts, summary, batches


def pcn_recipe(seed: int, dev, root: str, workdir: str):
    """The PCN recipe (``cfgs/PCN_models/AdaPoinTr.yaml``) from its tree:
    the 2-worker loader against the reader in this process, 1 +
    ``TRAIN_STEPS`` steps at batch 16 with the flagship's launch table and
    a profiled step, one checkpoint save timed, then ``validate`` and
    ``test`` (EMD) on 2 clouds at batch 1 and at ``--val_bs 2``, with their
    tables and every metric but EMD equal across the two to 1e-5, and
    :func:`emd_batch_check` on the test clouds."""
    config = cfg_from_yaml_file(CONFIG)
    for split in ("train", "val", "test"):
        root_paths(config.dataset[split], root)
    write_pcn_tree(config.dataset.train, seed)
    config.dataset.train.others.bs = B_TRAIN
    args = recipe_args(seed, workdir)
    dataset, train_loader = dataset_builder(args, config.dataset.train)
    loader = check_loader(dataset, config.dataset.train, seed)
    log(f"phase 8: PCN: the 2-worker loader's batches equal the reader's in this process: {json.dumps(loader)}")
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    require(runner.train_aug == "none", f"PCN: train_aug {runner.train_aug}")
    cfg = config.model
    counts, summary, _ = recipe_steps(runner, train_loader, train_step_calls(cfg), "the PCN recipe's steps")
    counts = {"pcn_train": counts}
    summary["checkpoint_save_ms"] = checkpoint_save_ms(runner)
    log(f"phase 8: one checkpoint save of the flagship (weights and AdamW state): "
        f"{json.dumps(summary['checkpoint_save_ms'])} ms")
    evals = {}
    for bs in (1, B_VAL):
        for split in ("val", "test"):
            config.dataset[split].others.bs = bs
        _, val_loader = dataset_builder(args, config.dataset.val)
        _, test_loader = dataset_builder(args, config.dataset.test)
        _build.reset_launches()
        metrics = port_runner.validate(runner, val_loader, 0, "silent")
        counts[f"pcn_validate_bs{bs}"] = check_launches(f"validate at batch {bs}", eval_calls(cfg, "validate"),
                                                        EVAL_CLOUDS // bs)
        _build.reset_launches()
        scores = port_runner.test(runner, test_loader, args, config, "silent")
        counts[f"pcn_test_bs{bs}"] = check_launches(f"test at batch {bs}", eval_calls(cfg, "test"), EVAL_CLOUDS // bs)
        require(all(np.isfinite(v) for v in metrics.state_dict().values()), f"PCN validate: {metrics}")
        require(all(np.isfinite(v) for v in scores.values()) and scores["EMDistance"] > 0, f"PCN test: {scores}")
        evals[f"batch {bs}"] = {"validate": metrics.state_dict(), "test": {k: float(v) for k, v in scores.items()}}
    for split in ("validate", "test"):  # the test's EMD: emd_batch_check
        for k in ("F-Score", "CDL1", "CDL2"):
            a, b = evals["batch 1"][split][k], evals[f"batch {B_VAL}"][split][k]
            require(abs(a - b) <= 1e-5 * max(abs(a), 1e-6), f"PCN {split} {k}: batch 1 {a}, batch {B_VAL} {b}")
    log(f"phase 8: PCN validate and test on {EVAL_CLOUDS} clouds at batch 1 and {B_VAL}: " + json.dumps(evals))
    summary["eval"] = evals
    summary["emd_batch"] = emd_batch_check(runner, test_loader)
    del runner
    torch.cuda.empty_cache()
    return counts, summary


def checkpoint_save_ms(runner, n: int = 3) -> list:
    """Host milliseconds of ``n`` saves of the runner's checkpoint (the
    weights and the optimizer's state, written with ``torch.save`` into the
    experiment directory): the cost that ``--save_freq`` skips."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.save("ckpt-last", 0, None, None)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def emd_batch_check(runner, test_loader) -> dict:
    """The test's EMD across batch sizes, with the forward taken apart from
    the auction: the first test batch (``B_VAL`` clouds) completed once,
    then the auction (``EMD_EPS``, ``EMD_ITERATIONS``) on those same dense
    clouds at batch ``B_VAL`` and one cloud at a time must give equal
    assignments and EMD rows within 1e-6 relative (the per-cloud mean's
    rounding); each cloud's own batch-1 forward, and the EMD of its dense
    cloud, are reported beside them."""
    batch = runner._to_device(next(iter(test_loader))[2])
    gt = batch["gt"]
    with torch.inference_mode():
        dense = runner._eval_core(batch)[1][1]
        assign = port_emd.emd_auction(dense, gt, EMD_EPS, EMD_ITERATIONS)[1]
        rows = compute_metrics_per_sample(dense, gt, require_emd=True, ignore_zeros=True)[:, 3]
        single_assign, single_rows, own_rows, own_dense = [], [], [], []
        for b in range(len(dense)):
            one = {k: v[b:b + 1] for k, v in batch.items()}
            single_assign.append(port_emd.emd_auction(dense[b:b + 1], gt[b:b + 1], EMD_EPS, EMD_ITERATIONS)[1])
            single_rows.append(compute_metrics_per_sample(dense[b:b + 1], gt[b:b + 1], require_emd=True,
                                                          ignore_zeros=True)[0, 3])
            own = runner._eval_core(one)[1][1]
            own_dense.append(own)
            own_rows.append(compute_metrics_per_sample(own, gt[b:b + 1], require_emd=True, ignore_zeros=True)[0, 3])
    single_rows, own_rows = torch.stack(single_rows), torch.stack(own_rows)
    own_dense = torch.cat(own_dense)
    out = {"clouds": len(dense), "assignments_equal": bool(torch.equal(assign, torch.cat(single_assign))),
           "emd_batch": rows.tolist(), "emd_one_at_a_time": single_rows.tolist(),
           "emd_rel_diff": float(((rows - single_rows).abs() / single_rows.abs()).max()),
           "own_forward_emd": own_rows.tolist(),
           "own_forward_emd_rel_diff": float(((rows - own_rows).abs() / own_rows.abs()).max()),
           "own_forward_dense_max_abs_diff": float((dense - own_dense).abs().max()),
           "own_forward_assignments_differ": int((assign != port_emd.emd_auction(
               own_dense, gt, EMD_EPS, EMD_ITERATIONS)[1]).sum())}
    log(f"phase 8: PCN test EMD on the same dense clouds at batch {len(dense)} and one at a time, and after each "
        f"cloud's own batch-1 forward: " + json.dumps(out))
    require(out["assignments_equal"], "the auction's assignment depends on the batch")
    require(out["emd_rel_diff"] <= 1e-6, f"the EMD rows depend on the batch: {out['emd_rel_diff']}")
    return out


def shapenet_recipe(seed: int, dev, root: str, workdir: str):
    """The ShapeNet-55 recipe (``cfgs/ShapeNet55_models/AdaPoinTr.yaml``)
    from its tree: 1 + ``TRAIN_STEPS`` steps at total_bs 64 with the crop
    (the flagship's table at 8192 points plus the crop's FPS and gathers), a
    profiled step and the crop's in-path FPS time; the 8-viewpoint test on
    2 clouds at ``--val_bs 2`` in each mode; one crop, its FPS and the
    forward at batch 2 against the CPU through the plain versions."""
    config = cfg_from_yaml_file(SHAPENET)
    require(int(config.total_bs) == B_SHAPENET, f"ShapeNet-55 total_bs {config.total_bs}")
    for split in ("train", "val", "test"):
        root_paths(config.dataset[split], root)
    write_shapenet_tree(config.dataset.train, B_SHAPENET * (TRAIN_STEPS + 2), EVAL_CLOUDS, seed + 1)
    config.dataset.train.others.bs = B_SHAPENET
    config.dataset.test.others.bs = B_VAL
    args = recipe_args(seed, workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, test_loader = dataset_builder(args, config.dataset.test)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    require((runner.train_aug, runner.train_npoints) == ("crop", N_SHAPENET),
            f"ShapeNet-55: train_aug {runner.train_aug} at {runner.train_npoints}")
    cfg = config.model
    calls = merged(train_step_calls(cfg), crop_calls(N_SHAPENET))
    counts, summary, batches = recipe_steps(runner, train_loader, calls, "the ShapeNet-55 recipe's steps")
    counts = {"shapenet_train": counts}
    batch = runner._to_device(batches[-1])
    timed_augment(runner, batch, 0.5)
    crop_prof = profile_run(lambda: timed_augment(runner, batch, 0.5))
    summary["crop"] = {"wall_ms": crop_prof.get("wall_ms"), "device_busy_ms": crop_prof.get("device_busy_ms"),
                       "fps_in_path_ms": crop_prof.get("ported_kernels_ms", {}).get("fps_kernel"),
                       "gather_in_path_ms": crop_prof.get("ported_kernels_ms", {}).get("gather_rows"),
                       "launches": crop_prof.get("launches")}
    log(f"phase 8: the ShapeNet-55 crop of one batch of {B_SHAPENET}, profiled: " + json.dumps(crop_prof))

    tests = {}
    for mode, ratio in port_runner.CROP_RATIO.items():
        num_crop = int(N_SHAPENET * ratio)
        _build.reset_launches()
        scores = port_runner.test(runner, test_loader, recipe_args(seed, workdir, mode=mode), config, "silent")
        counts[f"shapenet_test_{mode}"] = check_launches(f"the ShapeNet-55 test ({mode})",
                                                         shapenet_test_calls(cfg, N_SHAPENET, num_crop),
                                                         EVAL_CLOUDS // B_VAL)
        require(all(np.isfinite(v) for v in scores.values()) and scores["CDL1"] > 0, f"ShapeNet-55 {mode}: {scores}")
        tests[mode] = {k: float(v) for k, v in scores.items()}
    log(f"phase 8: the ShapeNet-55 8-viewpoint test on {EVAL_CLOUDS} clouds at batch {B_VAL}: " + json.dumps(tests))
    summary["test"] = tests
    summary["card_vs_cpu"] = shapenet_card_vs_cpu(runner, next(iter(test_loader))[2]["gt"], seed, dev)
    del runner
    torch.cuda.empty_cache()
    return counts, summary


def shapenet_card_vs_cpu(runner, gts, seed: int, dev) -> dict:
    """One train crop of 2 clouds (draws from a CPU generator: one cropped
    by the least and one by the most) on the card and on the CPU (the plain
    versions): the unit centres, the sorted orders, the kept clouds and the
    FPS picks equal; then the forward of the crops with the runner's
    weights on both, its last ranking layer scaled by 1000 as phase 5 does:
    clouds as sets and CD-L1 within phase 3's band."""
    g = torch.Generator().manual_seed(seed + 3)
    center = torch.randn(2, 1, 3, generator=g)
    num_crop = torch.tensor([[N_SHAPENET // 4], [3 * N_SHAPENET // 4]])
    out = []
    for where in (dev, torch.device("cpu")):
        gt = gts.to(where)
        unit = sampling._unit_center(center.to(where))
        order = sampling.view_order(gt, unit)
        kept = sampling.train_crop_kept(gt, unit, num_crop.to(where))
        picks = ops.furthest_point_sample(kept, N_PARTIAL)
        out.append([t.cpu() for t in (unit, order, kept, picks, ops.index_points(kept, picks))])
    for name, a, b in zip(("centres", "orders", "kept clouds", "FPS picks", "crops"), *out):
        require(torch.equal(a, b), f"the ShapeNet-55 crop, card against CPU: the {name} differ")
    model = runner.model.eval()
    cpu_model = build_model(runner.config.model, device="cpu", seed=seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for m in (model, cpu_model):
        with torch.no_grad():
            m.base_model.query_ranking[4].weight.mul_(1000.0)
    agree = cpu_agreement(model, cpu_model, {"partial": out[1][4].numpy(), "gt": gts.numpy()}, dev)
    log("phase 8: the ShapeNet-55 crop and forward at batch 2, card against CPU: crops equal; "
        + json.dumps(agree))
    require(min(agree["coarse_matched"], agree["fine_matched"]) >= 0.99,
            "ShapeNet-55: the card's clouds disagree with the CPU's")
    require(abs(agree["cd_l1_card"] - agree["cd_l1_cpu"]) <= 1e-2 * agree["cd_l1_cpu"],
            "ShapeNet-55: the card's CD-L1 disagrees with the CPU's")
    return {"crop_equal": True, **agree}


def kitti_recipe(seed: int, root: str, workdir: str):
    """The KITTI finetune (``cfgs/KITTI_models/AdaPoinTr.yaml``): PCN cars
    (``CARS``) from the PCN tree, 1 + ``TRAIN_STEPS`` steps at batch 16 with
    the dropping (the flagship's table plus the dropping's FPS and gather)
    and a profiled step. Its test protocol draws images with matplotlib,
    which the card's machine lacks: it is not driven here."""
    config = cfg_from_yaml_file(KITTI)
    root_paths(config.dataset.train, root)
    config.dataset.train.others.bs = B_TRAIN
    args = recipe_args(seed, workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    require(len(train_loader) == PCN_TAXONOMIES["02958343"] // B_TRAIN, "KITTI: the CARS filter")
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    require(runner.train_aug == "dropping", f"KITTI: train_aug {runner.train_aug}")
    calls = merged(train_step_calls(config.model), dropping_calls(N_PARTIAL))
    counts, summary, _ = recipe_steps(runner, train_loader, calls, "the KITTI finetune's steps")
    del runner
    torch.cuda.empty_cache()
    return {"kitti_train": counts}, summary


def recipes_phase(seed: int, dev, card: str):
    """Phase 8: the three recipes from trees written into a temporary
    directory (removed at the end); returns the launch counts and the
    summaries."""
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        counts, pcn = pcn_recipe(seed, dev, root, workdir)
        log(f"phase 8: PCN recipe on {card}: " + json.dumps(pcn))
        more, shapenet = shapenet_recipe(seed, dev, root, workdir)
        counts.update(more)
        log(f"phase 8: ShapeNet-55 recipe on {card}: " + json.dumps(shapenet))
        more, kitti = kitti_recipe(seed, root, workdir)
        counts.update(more)
        log(f"phase 8: KITTI finetune on {card}: " + json.dumps(kitti))
        log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(workdir, ignore_errors=True)
    return counts, {"pcn": pcn, "shapenet55": shapenet, "kitti": kitti}


# ------------------------------------------------------------ phase 9 path


def chamfer_calls(n_x: int, n_y: int, grad_x: bool = True, grad_y: bool = False) -> dict:
    """One ``nn_distance`` of clouds of n_x and n_y points: the argmin, the
    two residual gathers and, in a train step, one scatter for each cloud
    that needs a gradient (the other cloud's cross term)."""
    return {"nn_bidir_argmin": [(n_x, n_y)], "gather_rows": [(n_y, 3, n_x), (n_x, 3, n_y)],
            "scatter_add_rows": [(n_x, 3, n_y)] * grad_x + [(n_y, 3, n_x)] * grad_y}


def baseline_calls(cfg) -> dict:
    """Each kernel's calls per batch element of a baseline, from its model
    config: ``forward`` (the eval forward), ``train`` (a train step: the
    forward in train mode, the loss, the backward), and the eval clouds'
    sizes ``coarse`` and ``fine``. FoldingNet, PCN and TopNet launch
    nothing in their forward. SnowFlakeNet: FPS and its gather in the two
    set abstractions and on the seeds with the partial; kNN (k = 16) and
    the gathers of keys and positions in each transformer (the sets' groups
    too); its loss FPS's the ground truth down to P2, P1 and Pc. GRNet: the
    gridding's scatter (C = 1, 8 corners a point, into 64³ rows), the point
    sampling's gather over 2048 + 64³ rows and the three cubic samplings'
    gathers. In training each gather whose table needs a gradient adds its
    scatter."""
    name, N, k = cfg.NAME, N_PARTIAL, 16
    fwd = {"knn": [], "fps": [], "gather_rows": [], "scatter_add_rows": []}
    grad_gathers, loss_fps, loss_gathers = [], [], []
    if name in ("FoldingNet", "TopNet"):
        coarse = fine = int(cfg.num_pred)
        loss = [(fine, N_GT, True, False)] * 2
    elif name == "PCN":
        fine = int(cfg.num_pred)
        coarse = fine // 16
        loss = [(coarse, N_GT, True, False), (fine, N_GT, True, False)]
    elif name == "SnowFlakeNet":
        num_pc, n = int(cfg.num_pc), int(cfg.num_p0)
        fwd["fps"] = [(N, 512), (512, 128), (num_pc + N, n)]
        fwd["knn"] = [(k, 512, N), (k, 512, 512), (k, 128, 512), (k, 128, 128)]
        sets = [(512, 64, 512 * k), (512, 128, 128 * k), (128, 64, 128 * k)]  # keys, sa2's features
        fwd["gather_rows"] = [(N, 3, 512), (512, 3, 128), (num_pc + N, 3, n), (N, 3, 512 * k), (N, 3, 512 * k),
                              (512, 3, 512 * k), (512, 3, 128 * k), (128, 3, 128 * k)] + sets
        grad_gathers = [(num_pc + N, 3, n)] + sets
        sizes = [num_pc]
        for up in [1] + [int(u) for u in cfg.up_factors]:  # each SPD's skip transformer on its input
            fwd["knn"].append((k, n, n))
            grad_gathers += [(n, 64, n * k), (n, 3, n * k)]
            n *= up
            sizes.append(n)
        fwd["gather_rows"] += grad_gathers[4:]
        pc, p1, p2, p3 = sizes
        coarse, fine = p1, p3
        loss_fps = [(N_GT, p2), (p2, p1), (p1, pc)]
        loss_gathers = [(N_GT, 3, p2), (p2, 3, p1), (p1, 3, pc)]
        loss = [(pc, pc, True, False), (p1, p1, True, False), (p2, p2, True, False), (N, p3, False, True),
                (p3, N_GT, True, False)]
    elif name == "GRNet":
        fine = int(cfg.num_pred)
        coarse = fine // 8
        fwd["scatter_add_rows"] = [(GRNET_CELLS, 1, N * 8)]
        grad_gathers = [(N + GRNET_CELLS, 3, coarse)] + [(s**3, c, coarse * 8) for s, c in ((32, 32), (16, 64),
                                                                                               (8, 128))]
        fwd["gather_rows"] = list(grad_gathers)
        loss = [(coarse, N_GT, True, False), (fine, N_GT, True, False)]
    else:
        raise ValueError(f"{name} is no baseline")
    train = merged(fwd, {"fps": loss_fps, "gather_rows": loss_gathers, "scatter_add_rows": grad_gathers},
                   *[chamfer_calls(*c) for c in loss])
    return {"forward": fwd, "train": train, "coarse": coarse, "fine": fine}


def baseline_eval_calls(calls: dict, protocol: str) -> dict:
    """One cloud's calls in a request (``serve``: the forward and the
    metric suite's pass over the dense cloud), in ``validate`` (and the
    coarse cloud's pass) or in ``test`` at batch 1 (and the masked pass
    over the dense cloud, the table's exact F-score, the auction)."""
    fine, coarse = calls["fine"], calls["coarse"]
    out = merged(calls["forward"], {k: v for k, v in chamfer_calls(fine, N_GT, False).items()
                                    if k != "scatter_add_rows"})
    if protocol in ("validate", "test"):
        out = merged(out, {"nn_bidir_argmin": [(coarse, N_GT)], "gather_rows": [(N_GT, 3, coarse), (coarse, 3, N_GT)]})
    if protocol == "test":
        out = merged(out, {"nn_one_direction": [(fine, N_GT), (N_GT, fine)], "nn_bidir_argmin": [(fine, N_GT)],
                           "gather_rows": [(N_GT, 3, fine), (fine, 3, N_GT)] * 2, "auction_top2": None})
    return out


def serve_baseline(model, calls: dict, batches, dev):
    """Answer each request with a baseline; per-request seconds and metrics."""
    secs, scores = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            coarse, fine = model(torch.from_numpy(batch["partial"]).to(dev))
            f, l1, l2 = eval_metric_suite(fine, torch.from_numpy(batch["gt"]).to(dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        n = batch["partial"].shape[0]
        require(tuple(coarse.shape) == (n, calls["coarse"], 3) and tuple(fine.shape) == (n, calls["fine"], 3),
                f"{type(model).__name__}: shapes {tuple(coarse.shape)} {tuple(fine.shape)}")
        require(bool(torch.isfinite(coarse).all() and torch.isfinite(fine).all()), "non-finite output")
        scores.append((float(f), float(l1), float(l2)))
        require(all(np.isfinite(v) for v in scores[-1]), f"non-finite metrics {scores[-1]}")
    return secs, scores


def loader_batches(loader, n: int) -> list:
    """The loader's first ``n`` batches, epoch after epoch."""
    out, epoch = [], 0
    while len(out) < n:
        loader.set_epoch(epoch)
        out += [b for _, _, b in itertools.islice(loader, n - len(out))]
        epoch += 1
    return out


def grnet_noise(b: int, seed: int) -> torch.Tensor:
    """Uniform point-sampling scores for GRNet's (2048 + 64³)-row cloud."""
    return torch.rand(b, N_PARTIAL + GRNET_CELLS, generator=torch.Generator().manual_seed(seed))


def baseline_determinism(runner, batch, epoch_f: float, noise, deterministic: bool = True) -> dict:
    """One train step's gradients (no optimizer step) twice from the same
    state, batch and draws, on cuDNN's deterministic algorithms as the
    runner's step takes them (``deterministic``) or on its default ones:
    whether the outputs, the loss's gradient with respect to the predicted
    clouds on the first run's clouds (the chamfer backward) and every
    parameter's gradient agree bit for bit; the chamfer's is always
    required equal, the others under ``deterministic``, and the differing
    parameters listed. State and generator restored."""
    model = runner.model
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = runner.generator.get_state()
    batch = runner._to_device(batch)
    noise = None if noise is None else noise.to(batch["gt"].device)
    runs = []
    for _ in range(2):
        model.load_state_dict(state)
        runner.generator.set_state(gen)
        model.train()
        model.zero_grad(set_to_none=True)
        with deterministic_cudnn() if deterministic else contextlib.nullcontext():
            ret = model(*runner._inputs(batch), bn_momentum=runner.bnm_sched(epoch_f),
                        generator=runner.generator, noise=noise)
            sum(model.loss(ret, batch["gt"], epoch_f)).backward()
        runs.append(([t.detach().clone() for t in ret],
                     {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
    model.load_state_dict(state)
    runner.generator.set_state(gen)
    model.zero_grad(set_to_none=True)
    (r1, p1), (r2, p2) = runs
    iso = []
    for _ in range(2):  # the loss's gradient on run 1's clouds, the forward held fixed
        leaves = [t.clone().requires_grad_(t.dtype.is_floating_point) for t in r1]
        iso.append(torch.autograd.grad(sum(model.loss(tuple(leaves), batch["gt"], epoch_f)),
                                       [x for x in leaves if x.requires_grad], allow_unused=True))
    differ = sorted(n for n in p1 if not torch.equal(p1[n], p2[n]))
    out = {"outputs_equal": all(torch.equal(a, b) for a, b in zip(r1, r2)),
           "cloud_grads_equal_fixed_forward": all(a is None and b is None or torch.equal(a, b)
                                                  for a, b in zip(*iso)),
           "param_grads_equal": not differ, "param_grads_differing": len(differ), "params_with_grad": len(p1),
           "differing": differ,
           "max_abs_param_grad_diff": max((float((p1[n] - p2[n]).abs().max()) for n in differ), default=0.0)}
    log(f"phase 9: {type(model).__name__}: one train step's gradients twice from the same state, cuDNN "
        f"{'deterministic' if deterministic else 'default'}: " + json.dumps(out))
    require(out["cloud_grads_equal_fixed_forward"], "the loss's gradient on fixed clouds differs between runs")
    require(not deterministic or out["outputs_equal"] and out["param_grads_equal"],
            f"{type(model).__name__}: {len(differ)} parameters' gradients differ between two runs ({differ[:5]})")
    return out


def without_deterministic_cudnn(run):
    """``run()`` with ``Runner.train_step`` on cuDNN's default algorithms:
    its :func:`deterministic_cudnn` replaced by a no-op for the call."""
    saved = port_runner.deterministic_cudnn
    port_runner.deterministic_cudnn = contextlib.nullcontext
    try:
        return run()
    finally:
        port_runner.deterministic_cudnn = saved


def grnet_step_on_default_cudnn(runner, batches, noise, steps: int) -> dict:
    """GRNet's train step on cuDNN's default algorithms: 1 warm-up and
    ``steps`` timed steps, a profiled one and the two-run gradients."""
    step = lambda b, e: timed_step(runner, b, e, noise=noise)[0]  # noqa: E731
    without_deterministic_cudnn(lambda: step(batches[0], 0.5))
    times = [without_deterministic_cudnn(lambda: step(b, 0.5)) for b in batches[1:1 + steps]]
    prof = without_deterministic_cudnn(lambda: profile_run(lambda: step(batches[-1], 0.9)))
    det = baseline_determinism(runner, batches[-1], 0.9, noise, deterministic=False)
    return {"median_step_ms": statistics.median(times) * 1e3, "step_ms": [t * 1e3 for t in times],
            "profiled_step": {k: v for k, v in prof.items() if k != "top"},
            "step_determinism": {k: det[k] for k in ("outputs_equal", "param_grads_equal", "param_grads_differing",
                                                     "params_with_grad", "max_abs_param_grad_diff")}}


def baseline_card_vs_cpu(config, seed: int, workdir: str) -> dict:
    """One train step at batch 2 and full width on the card against the
    same step on the CPU through the plain versions: same weights, batch
    and point-sampling scores (GRNet)."""
    data = SyntheticPCN({"N_POINTS": N_GT, "N_PARTIAL": N_PARTIAL, "LENGTH": 2, "SEED": seed + 1,
                         "others": {"subset": "train"}})
    samples = [data.get(i, None)[2] for i in range(2)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}
    noise = grnet_noise(2, seed) if config.model.NAME == "GRNet" else None
    out = {}
    for device in ("cuda", "cpu"):
        runner = port_runner.Runner(types.SimpleNamespace(device=device, seed=seed, experiment_path=workdir),
                                    config, logger="silent")
        runner.make_train_state(1)
        require(next(runner.model.parameters()).device.type == device, f"the {device} runner's model is elsewhere")
        m = runner.train_step(batch, 0.0, noise=noise)
        out[device] = {k: float(m[k]) for k in ("total_loss", "grad_norm")}
        del runner
    for k in ("total_loss", "grad_norm"):
        out[f"{k}_rel_diff"] = abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
    return out


def check_gridding(g, dev) -> dict:
    """GRNet's point ops at its train batch (32 clouds of 2048 points):
    the gridding (64³, its scatter at C = 1) and the three cubic
    samplings with their VJPs, twice on the card (the same bits) and on
    the CPU (the same bits but for the points' gradient, a sum over each
    point's corners in the reduction's own order: 1e-5)."""
    b = 32
    pts = torch.rand(b, N_PARTIAL, 3, generator=g) - 0.5
    pts[0, 1500:] = 0.0
    vols = [torch.randn(b, s, s, s, c, generator=g) for s, c in ((32, 32), (16, 64), (8, 128))]
    w = torch.randn(b, 64, 64, 64, generator=g)
    runs = {}
    for device in ("cuda", "cuda", "cpu"):
        p = pts.to(device).requires_grad_(True)
        fs = [v.to(device).requires_grad_(True) for v in vols]
        grid = port_gridding.gridding(p, 64)
        sampled = [port_gridding.cubic_feature_sampling(p[:, :256] * 2.0, f) for f in fs]
        loss = (grid * w.to(device)).sum() + sum(t.square().sum() for t in sampled)
        loss.backward()
        runs.setdefault(device, []).append([t.detach().cpu() for t in [grid, *sampled, p.grad, *[f.grad for f in fs]]])
    (a, b2), (c,) = runs["cuda"], runs["cpu"]
    require(all(torch.equal(x, y) for x, y in zip(a, b2)), "gridding / cubic sampling: two card runs differ")
    same = [torch.equal(x, y) for i, (x, y) in enumerate(zip(a, c)) if i != 4]
    require(all(same), f"gridding / cubic sampling: the card differs from the CPU ({same})")
    dp = float((a[4] - c[4]).abs().max() / c[4].abs().max())
    require(dp <= 1e-5, f"gridding: the points' gradient differs from the CPU's by {dp}")
    out = {"batch": b, "card_runs_equal": True, "card_equals_cpu": True, "points_grad_rel_diff": dp}
    log("phase 9: GRNet's gridding and cubic sampling with their VJPs: " + json.dumps(out))
    return out


def baseline_phase(name: str, seed: int, dev, card: str, root: str, workdir: str):
    """Phase 9 for one baseline (see the module docstring); returns the
    launch counts and the summary."""
    config = cfg_from_yaml_file(f"cfgs/PCN_models/{name}.yaml")
    for split in ("train", "val", "test"):
        root_paths(config.dataset[split], root)
    cfg = config.model
    calls = baseline_calls(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 9: {name} built on {dev}, {n_params} parameters, {time.perf_counter() - t0:.1f} s")
    requests = make_requests(cfg, seed, REQUESTS + 1)
    serve_baseline(model, calls, requests[:1], dev)  # warm-up
    _build.reset_launches()
    secs, scores = serve_baseline(model, calls, requests[1:], dev)
    counts = {f"{name}_request": check_launches(f"{name}'s requests", baseline_eval_calls(calls, "serve"), REQUESTS)}
    prof = profile_run(lambda: serve_baseline(model, calls, [requests[1]], dev)[0][0])
    log(f"phase 9: {name}: {REQUESTS} requests of {B} x {N_PARTIAL} -> {calls['fine']}: "
        f"{json.dumps([round(t * 1e3, 2) for t in secs])} ms; metrics (F, CD-L1, CD-L2) {json.dumps(scores)}; "
        f"one profiled request: {json.dumps(prof)}")
    cudnn = {}
    if name == "GRNet":  # the same requests on cuDNN's deterministic algorithms, as a train step runs
        with deterministic_cudnn():
            serve_baseline(model, calls, requests[:1], dev)
            det_secs, _ = serve_baseline(model, calls, requests[1:], dev)
            det_prof = profile_run(lambda: serve_baseline(model, calls, [requests[1]], dev)[0][0])
        cudnn["request_deterministic"] = {"median_request_ms": statistics.median(det_secs) * 1e3,
                                          "profiled_request": {k: v for k, v in det_prof.items() if k != "top"}}
        log("phase 9: GRNet: requests on cuDNN's deterministic algorithms: "
            + json.dumps(cudnn["request_deterministic"]))
    del model
    torch.cuda.empty_cache()

    bs = int(config.total_bs)
    config.dataset.train.others.bs = bs
    for split in ("val", "test"):
        config.dataset[split].others.bs = 1
    args = recipe_args(seed, workdir)
    _, train_loader = dataset_builder(args, config.dataset.train)
    _, val_loader = dataset_builder(args, config.dataset.val)
    _, test_loader = dataset_builder(args, config.dataset.test)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(train_loader))
    batches = loader_batches(train_loader, BASELINE_STEPS + 2)
    before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
    train, times, peak = run_train_steps(runner, batches, calls["train"], f"{name}'s train steps", "phase 9",
                                         steps=BASELINE_STEPS)
    counts[f"{name}_train"] = train
    check_trained(runner.model, before)
    noise = grnet_noise(bs, seed + 2) if name == "GRNet" else None
    step_prof = profile_run(lambda: timed_step(runner, batches[-1], 0.9, noise=noise)[0])
    log(f"phase 9: {name}: one profiled train step at {bs}: " + json.dumps(step_prof))
    _build.reset_launches()
    metrics = port_runner.validate(runner, val_loader, 0, "silent")
    counts[f"{name}_validate"] = check_launches(f"{name}'s validate", baseline_eval_calls(calls, "validate"),
                                                EVAL_CLOUDS)
    _build.reset_launches()
    table = port_runner.test(runner, test_loader, args, config, "silent")
    counts[f"{name}_test"] = check_launches(f"{name}'s test", baseline_eval_calls(calls, "test"), EVAL_CLOUDS)
    require(all(np.isfinite(v) for v in metrics.state_dict().values()), f"{name} validate: {metrics}")
    require(all(np.isfinite(v) for v in table.values()) and table["EMDistance"] > 0, f"{name} test: {table}")
    log(f"phase 9: {name}: validate on {EVAL_CLOUDS} clouds {json.dumps(metrics.state_dict())}; test (EMD, "
        f"{counts[f'{name}_test']['auction_top2']} top-2 launches) {json.dumps({k: float(v) for k, v in table.items()})}")
    determinism = None
    if name in ("SnowFlakeNet", "GRNet"):
        determinism = baseline_determinism(runner, batches[-1], 0.9, noise)
    if name == "GRNet":
        cudnn["step_default"] = grnet_step_on_default_cudnn(runner, batches, noise, BASELINE_STEPS)
        log("phase 9: GRNet: train steps on cuDNN's default algorithms: " + json.dumps(cudnn["step_default"]))
    train_loader.close()
    del runner, batches
    torch.cuda.empty_cache()
    agree = baseline_card_vs_cpu(config, seed, workdir)
    log(f"phase 9: {name}: card vs CPU, one step at batch 2: " + json.dumps(agree))
    require(agree["total_loss_rel_diff"] <= 1e-4, f"{name}: the card's loss disagrees with the CPU's")
    require(agree["grad_norm_rel_diff"] <= 1e-3, f"{name}: the card's gradient norm disagrees with the CPU's")
    summary = {"params": n_params, "request_batch": B, "median_request_ms": statistics.median(secs) * 1e3,
               "profiled_request": {k: v for k, v in prof.items() if k != "top"},
               "train_batch": bs, "step_ms": [t * 1e3 for t in times], "median_step_ms": statistics.median(times) * 1e3,
               "max_memory_allocated_gib": peak / 2**30,
               "profiled_step": {k: v for k, v in step_prof.items() if k != "top"},
               "card_vs_cpu_step": {k: agree[k] for k in ("total_loss_rel_diff", "grad_norm_rel_diff")},
               "step_determinism": determinism}
    if cudnn:
        summary["cudnn"] = cudnn
    return counts, summary


def k2_check(seed: int, workdir: str) -> dict:
    """``AdaPoinTr-tiny-k2.yaml`` (``step_per_update: 2``) on synthetic data
    at its total_bs: 4 train steps; the parameters and the optimizer move on
    the 2nd and the 4th only, and only those log a gradient norm."""
    config = cfg_from_yaml_file(K2)
    bs = int(config.total_bs)
    swap_synthetic(config, train_len=4 * bs)
    config.dataset.train.others.bs = bs
    args = types.SimpleNamespace(device="cuda", seed=seed, num_workers=0, experiment_path=workdir)
    _, loader = dataset_builder(args, config.dataset.train)
    runner = port_runner.Runner(args, config, logger="silent")
    runner.make_train_state(len(loader))
    moved, logged, steps = [], [], []
    for i, (_, _, batch) in enumerate(loader):
        before = {n: p.detach().clone() for n, p in runner.model.named_parameters()}
        m = runner.train_step(batch, i / len(loader))
        moved.append(any(not torch.equal(p, before[n]) for n, p in runner.model.named_parameters()))
        logged.append("grad_norm" in m)
        steps.append(sorted({int(st["step"]) for st in runner.optimizer.state.values()}))
    out = {"batch": bs, "steps": len(moved), "moved": moved, "grad_norm_logged": logged, "optimizer_steps": steps}
    log("phase 9: AdaPoinTr-tiny-k2 (step_per_update 2): " + json.dumps(out))
    require(moved == logged == [False, True, False, True] and steps[-1] == [2],
            "step_per_update 2: the optimizer did not step once every 2 batches")
    return out


def baselines_phase(seed: int, dev, card: str):
    """Phase 9: the five baselines on a PCN tree written into a temporary
    directory (removed at the end), then the k = 2 check; returns the launch
    counts and the summaries."""
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        pcn = cfg_from_yaml_file(CONFIG).dataset.train
        root_paths(pcn, root)
        write_pcn_tree(pcn, seed)
        counts, summary = {}, {"gridding": check_gridding(torch.Generator().manual_seed(seed), dev)}
        for name in BASELINES:
            more, summary[name] = baseline_phase(name, seed, dev, card, root, workdir)
            counts.update(more)
            log(f"phase 9: {name} on {card}: " + json.dumps(summary[name]))
        summary["k2"] = k2_check(seed, workdir)
        log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(workdir, ignore_errors=True)
    return counts, summary

# ----------------------------------------------------------- phase 10 path


def serving_calls(cfg) -> dict:
    """The calls of one request of the serving entry points (the CLI,
    ``PCReconstructor``): :func:`request_calls` without the metrics' pass
    and its two residual gathers."""
    calls = dict(request_calls(cfg), scatter_add_rows=[], nn_one_direction=[], nn_bidir_argmin=[])
    calls["gather_rows"] = calls["gather_rows"][:-2]
    return calls


def save_pth(model, path: str) -> str:
    torch.save({"base_model": model.state_dict()}, path)
    return path


@torch.inference_mode()
def own_forward(model, arrays: list, dev) -> np.ndarray:
    """The dense cloud of the model's own eval forward on ``arrays`` (batch 1)."""
    model.eval()
    return model(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays])[-1][0].cpu().numpy()


def cli_check(seed: int, dev, workdir: str) -> tuple:
    """Phase 10 (a): the serving CLI over one cloud in every format, then
    ``PCReconstructor`` once on the same weights; returns their launch
    counts and a summary."""
    cfg = cfg_from_yaml_file(CONFIG).model
    model = build_model(cfg, device=dev, seed=seed)
    ckpt = save_pth(model, os.path.join(workdir, "flagship.pth"))
    cloud = make_requests(cfg, seed + 10, 1, b=1)[0]["partial"][0][:N_CLI_PARTIAL]
    root = os.path.join(workdir, "clouds")
    os.makedirs(root)
    formats = ["npy", "pcd", "ply", "txt"]
    try:
        import h5py  # noqa: F401  (IO's .h5 reader)

        formats.append("h5")
    except ImportError:
        log("phase 10: h5py does not import here: no .h5 cloud")
    for ext in formats:
        IO.put(os.path.join(root, f"cloud_{ext}.{ext}"), cloud)
    out = os.path.join(workdir, "cli_out")
    argv = ["--model_config", CONFIG, "--model_checkpoint", ckpt, "--pc_root", root, "--out_pc_root", out,
            "--device", dev.type]
    port_inference.main(argv)  # warm-up (cuBLAS handles, caches)
    single, per_file = port_inference.inference_single, []

    def timed(*a, **kw):  # a file's request: read, upsample, forward, save (ends on the host)
        t = time.perf_counter()
        out = single(*a, **kw)
        per_file.append((a[1], time.perf_counter() - t))
        return out

    _build.reset_launches()
    port_inference.inference_single = timed
    try:
        t0 = time.perf_counter()
        port_inference.main(argv)
        secs = time.perf_counter() - t0
    finally:
        port_inference.inference_single = single
    counts = {"cli": check_launches("the CLI's requests", serving_calls(cfg), len(formats))}
    up = port_inference.UpSamplePoints({"n_points": N_PARTIAL})(cloud, np.random.default_rng(0))
    want = own_forward(model, [up[None]], dev)
    txt_err = None
    for ext in formats:
        fine = np.load(os.path.join(out, f"cloud_{ext}", "fine.npy"))
        require(fine.shape == (int(cfg.num_points), 3) and bool(np.isfinite(fine).all()), f"CLI .{ext}: {fine.shape}")
        if ext == "txt":
            txt_err = float(np.abs(fine - want).max())
            require(txt_err <= TXT_ATOL, f"CLI .txt: {txt_err} from the model's own forward")
        else:
            require(np.array_equal(fine, want), f"CLI .{ext}: fine.npy differs from the model's own forward")
    rec = PCReconstructor(CONFIG, ckpt, device=dev.type)
    pcd = os.path.join(root, "cloud_pcd.pcd")
    rec.predict(pcd)  # warm-up
    _build.reset_launches()
    got = rec.predict(pcd)
    counts["reconstructor_flagship"] = check_launches("a flagship PCReconstructor request", serving_calls(cfg), 1)
    tiled = rec.preprocess_point_cloud(pcd)
    require(np.array_equal(got, own_forward(model, [tiled], dev)),
            "PCReconstructor (flagship): differs from the model's own forward")
    summary = {"formats": formats, "files": len(formats), "cli_main_ms": secs * 1e3,
               "file_ms": {name: t * 1e3 for name, t in per_file}, "txt_max_abs_err": txt_err,
               "launches_per_request": {k: v // len(formats) for k, v in counts["cli"].items() if v}}
    log(f"phase 10: the CLI over {len(formats)} files ({', '.join(formats)}) on the card: every fine.npy "
        f"equal to the model's own forward (.txt within {txt_err:.3g}); " + json.dumps(summary))
    del model, rec
    return counts, summary


def reconstructor_check(seed: int, dev, card: str, workdir: str) -> tuple:
    """Phase 10 (b): ``PCReconstructor`` on the superset, 1 warm-up and
    ``REQUESTS`` timed requests; returns the launch counts and a summary."""
    cfg = cfg_from_yaml_file(SUPERSET).model
    model = build_model(cfg, device=dev, seed=seed)
    ckpt = save_pth(model, os.path.join(workdir, "superset.pth"))
    sample = make_requests(cfg, seed + 11, 1, b=1)[0]
    pcd = os.path.join(workdir, "superset.pcd")
    IO.put(pcd, sample["partial"][0])
    rec = PCReconstructor(SUPERSET, ckpt, device=dev.type)
    require(rec.inputs == ("partial", "img", "cls_vec"), f"the superset takes {rec.inputs}")
    try:
        from PIL import Image

        png = os.path.join(workdir, "view.png")
        Image.fromarray((sample["img"][0] * 255).astype(np.uint8)).save(png)
        request = lambda: rec.predict(pcd, png, CLASS_ID, CLASSES)  # noqa: E731
        img, how = rec.load_image(png), "predict with a .png"
    except ImportError:
        img, how = sample["img"][:1], "forward on the decoded image array (PIL does not import here)"
        request = lambda: rec.forward(rec.preprocess_point_cloud(pcd), img,  # noqa: E731
                                      rec.prepare_cls_vec(CLASSES, CLASS_ID))
    log(f"phase 10: PCReconstructor on the superset: {how}")
    want = own_forward(model, [rec.preprocess_point_cloud(pcd), img, rec.prepare_cls_vec(CLASSES, CLASS_ID)], dev)
    request()  # warm-up
    _build.reset_launches()
    secs = []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = request()
        secs.append(time.perf_counter() - t0)
        require(np.array_equal(got, want), "PCReconstructor (superset): differs from the model's own forward")
    counts = {"reconstructor_superset": check_launches("the superset's PCReconstructor requests",
                                                       serving_calls(cfg), REQUESTS)}
    summary = {"how": how, "request_ms": [t * 1e3 for t in secs], "median_request_ms": statistics.median(secs) * 1e3,
               "launches_per_request": {k: v // REQUESTS for k, v in counts["reconstructor_superset"].items() if v}}
    log(f"phase 10: PCReconstructor, superset at batch 1: median {summary['median_request_ms']:.2f} ms on {card}; "
        + json.dumps(summary))
    del model, rec
    return counts, summary


def trace_kernels(path: str) -> dict:
    """{kernel name: count} of the CUDA kernel events of a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def profile_main_check(seed: int, dev, workdir: str) -> tuple:
    """Phase 10 (c) and (e): ``main --synthetic --profile`` on the flagship
    for one epoch of ``PROFILE_STEPS`` steps, run from ``workdir`` (which
    holds a link to ``cfgs/`` and the config copy with ``max_epoch: 1``)."""
    config = os.path.join(workdir, "profile_cfgs", os.path.basename(CONFIG))
    os.makedirs(os.path.dirname(config))
    with open(CONFIG) as f:
        text = f.read()
    require(text.count("\nmax_epoch:") == 1, f"{CONFIG}: no max_epoch line to cut")
    with open(config, "w") as f:
        f.write("\n".join("max_epoch: 1" if line.startswith("max_epoch:") else line for line in text.split("\n")))
    cfg = cfg_from_yaml_file(config)
    require(int(cfg.total_bs) == B_TRAIN and int(cfg.max_epoch) == 1, "the profile config's batch or epochs")
    os.symlink(os.path.abspath("cfgs"), os.path.join(workdir, "cfgs"))
    here = os.getcwd()
    os.chdir(workdir)
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        runner = port_main(["--config", config, "--exp_name", "profile", "--synthetic", "--seed", str(seed),
                            "--syn_train_len", str(PROFILE_STEPS * B_TRAIN), "--profile", "--device", dev.type])
        secs = time.perf_counter() - t0
        n_val = 16  # swap_synthetic's validation split
        calls = merged(*([train_step_calls(cfg.model)] * PROFILE_STEPS + [eval_calls(cfg.model, "validate")] * n_val))
        counts = {"profiled_main": check_launches("the profiled main run", calls, 1)}
        require(runner.step == PROFILE_STEPS, f"main took {runner.step} steps")
        tb = os.path.abspath(runner.args.tfboard_path)
        traces = [os.path.join(tb, f) for f in os.listdir(tb) if f.endswith(".pt.trace.json")]
        require(len(traces) == 1, f"{len(traces)} traces under {tb}")
        kernels = trace_kernels(traces[0])
        seen = {k: sum(n for name, n in kernels.items() if ev in name) for k, ev in STEP_KERNEL_EVENTS.items()}
        log(f"phase 10: --profile wrote {os.path.relpath(traces[0], workdir)} "
            f"({os.path.getsize(traces[0]) / 2**20:.1f} MiB); the ported kernels' events in it: " + json.dumps(seen))
        require(all(seen.values()), f"--profile: a ported kernel of the step is missing from the trace: {seen}")
        train = [k for k in train_step_calls(cfg.model) if train_step_calls(cfg.model)[k]]
        require(set(train) <= set(STEP_KERNEL_EVENTS), f"kernels of the step without an event name: {train}")
        writers = {}
        for part in ("train", "test"):
            d = os.path.join(tb, part)
            writers[part] = sorted(f for f in os.listdir(d) if "tfevents" in f) if os.path.isdir(d) else []
        try:
            import tensorboardX  # noqa: F401
            on = True
        except ImportError:
            try:
                import tensorboard  # noqa: F401
                on = True
            except ImportError:
                on = False
        if on:
            require(all(writers.values()), f"the TensorBoard writers wrote no event file: {writers}")
            log(f"phase 10: the writers' event files: {json.dumps(writers)}")
        else:
            require(not any(writers.values()), f"event files without a writer: {writers}")
            log("phase 10: the TensorBoard writers are off: neither tensorboardX nor tensorboard imports here")
    finally:
        os.chdir(here)
    summary = {"main_s": secs, "steps": runner.step, "trace_mib": os.path.getsize(traces[0]) / 2**20,
               "trace_kernel_events": seen, "writers": on}
    del runner
    torch.cuda.empty_cache()
    return counts, summary


def worker_modes_check(seed: int, root: str, workdir: str, step_ms) -> dict:
    """Phase 10 (d): the ShapeNet-55 loader at batch ``B_SHAPENET`` over a
    tree of ``LOADER_BATCHES`` batches, in this process (0 workers) and with
    ``LOADER_WORKERS`` threads and processes. Epoch 0 starts the workers and
    warms the recipe's runner; epoch 1 is read alone (host ms a batch: the
    epoch's time over its batches), and its batches must be bit-equal across
    the three; epoch 2 feeds the runner's train steps (ms a step, loader
    included), beside the same steps on batches already in memory."""
    config = cfg_from_yaml_file(SHAPENET)
    for split in ("train", "val", "test"):
        root_paths(config.dataset[split], root)
    write_shapenet_tree(config.dataset.train, B_SHAPENET * LOADER_BATCHES, 0, seed + 12)
    config.dataset.train.others.bs = B_SHAPENET
    runner = port_runner.Runner(recipe_args(seed, workdir), config, logger="silent")
    runner.make_train_state(LOADER_BATCHES)

    def train_ms(batches) -> float:
        """ms a train step over ``batches`` (the loader's tuples), loader included."""
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for i, (_, _, batch) in enumerate(batches):
            runner.train_step(batch, 1.0 + i / LOADER_BATCHES)
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    got, timing = {}, {}
    for key, workers, mode in (("none", 0, "thread"), ("threads", LOADER_WORKERS, "thread"),
                               ("processes", LOADER_WORKERS, "process")):
        args = types.SimpleNamespace(seed=seed, num_workers=workers, worker_mode=mode)
        _, loader = dataset_builder(args, config.dataset.train)
        try:
            loader.set_epoch(0)
            t0 = time.perf_counter()
            it = iter(loader)
            first = next(it)
            start_ms = (time.perf_counter() - t0) * 1e3
            train_ms(itertools.chain([first], it))  # warm-up steps
            loader.set_epoch(1)
            t0 = time.perf_counter()
            got[key] = [batch for _, _, batch in loader]
            epoch_ms = (time.perf_counter() - t0) * 1e3
            loader.set_epoch(2)
            step_with_loader = train_ms(loader)
        finally:
            loader.close()
        require(len(got[key]) == LOADER_BATCHES, f"{key}: {len(got[key])} batches")
        timing[key] = {"first_batch_ms_epoch0": start_ms, "loader_ms_per_batch": epoch_ms / LOADER_BATCHES,
                       "step_ms_with_loader": step_with_loader}
    for key in ("threads", "processes"):
        for b, (x, y) in enumerate(zip(got[key], got["none"])):
            require(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x),
                    f"--worker_mode: batch {b} of the {key} differs from 0 workers'")
    in_memory = train_ms([(None, None, b) for b in got["none"]])
    summary = {"batch": B_SHAPENET, "workers": LOADER_WORKERS, "batches": LOADER_BATCHES, "equal": True,
               **timing, "step_ms_batches_in_memory": in_memory, "phase8_shapenet55_step_ms": step_ms}
    log("phase 10: the ShapeNet-55 loader, 0 workers, threads and processes: " + json.dumps(summary))
    del runner
    torch.cuda.empty_cache()
    return summary


def entry_points_phase(seed: int, dev, card: str, shapenet_step_ms) -> tuple:
    """Phase 10: the entry points on the card; returns the launch counts of
    each path and the summary."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    t0 = time.perf_counter()
    try:
        counts, cli = cli_check(seed, dev, workdir)
        more, rec = reconstructor_check(seed, dev, card, workdir)
        counts.update(more)
        more, prof = profile_main_check(seed, dev, workdir)
        counts.update(more)
        loaders = worker_modes_check(seed, root, workdir, shapenet_step_ms)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return counts, {"cli": cli, "reconstructor_superset": rec, "profile": prof, "worker_modes": loaders}


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
    hmma = mxu_hmma(_build.build())
    log(f"phase 1: the matmul-form kernel's SASS holds {hmma} HMMA instructions")
    require(hmma > 0, "the matmul-form kernel does not run on the tensor cores")

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
    # kNN: the superset step's GDANet pass (the normals at B_TRAIN) and the
    # deformable model's own searches, request and step
    extra["knn"] += [(B_TRAIN, c) for c in gdanet_calls(int(seg_cfgs[0].num_query))["knn"]]
    extra["knn"] += [(B, c) for c in request_calls(dcfg)["knn"]] + [(B_TRAIN, c) for c in d_train["knn"]]
    # the scatter-add at the superset's and the deformable model's train steps
    extra["scatter_add_rows"] = [(B_TRAIN, c) for c in superset_train_calls(seg_cfgs[0])["scatter_add_rows"]
                                 + d_train["scatter_add_rows"]]
    extra.update(three_nn_interpolate=[(B_TRAIN, c) for c in d_train["three_nn_interpolate"]],
                 nn_bidir_mxu=[(2, (4097, n_fine - 1))],
                 weighted_gather_sum_dfeats=[(B_TRAIN, c) for c in bwd] + bwd_extra)
    # the recipes' new shapes (phase 8): the ShapeNet-55 train crop's sort
    # and FPS gathers at B_SHAPENET and its chamfer at 8192 x 8192; the test
    # crops' gathers at 8 viewpoints x B_VAL; the KITTI dropping's gather
    # (FPS: recipe_fps_inputs, inside check_fps)
    n_test = len(port_runner.SHAPENET55_VIEWPOINTS) * B_VAL
    extra["gather_rows"] += [(B_SHAPENET, c) for c in crop_calls(N_SHAPENET)["gather_rows"]]
    extra["gather_rows"] += [(n_test, c) for r in port_runner.CROP_RATIO.values()
                             for c in shapenet_test_calls(cfg, N_SHAPENET, int(N_SHAPENET * r))["gather_rows"][-2:]]
    extra["gather_rows"] += [(B_TRAIN, c) for c in dropping_calls(N_PARTIAL)["gather_rows"]]
    extra["nn_bidir_argmin"] += [(B_SHAPENET, (N_SHAPENET, N_SHAPENET))]
    # the recipes' model calls: the ShapeNet-55 train step at B_SHAPENET
    # (its denoise kNN of 64 queries against 8192 points, its chamfers at
    # 8192, every scatter of its backward), its test batch's eval calls at
    # 8 viewpoints x B_VAL, and the PCN validate and test at batch 1 and
    # B_VAL (kNN's chunk count depends on the batch)
    sn_cfg = cfg_from_yaml_file(SHAPENET).model
    recipe_tables = [(B_SHAPENET, train_step_calls(sn_cfg)), (n_test, eval_calls(sn_cfg, "validate"))]
    recipe_tables += [(b, eval_calls(cfg, "test")) for b in (1, B_VAL)]
    # the baselines' train steps at their total_bs (phase 9): SnowFlakeNet's
    # FPS (16384 -> 2048 among them), kNN and gathers at 64, GRNet's
    # volumes, sampled rows and gridding scatter at 32, every loss's argmin
    recipe_tables += [(int(bc.total_bs), baseline_calls(bc.model)["train"])
                      for bc in (cfg_from_yaml_file(f"cfgs/PCN_models/{n}.yaml") for n in BASELINES)]
    # the options flagship (phase 11): the pn grouper's FPS 2048 -> 256, its
    # k = 32 search and gathers, the fold head's 32768-point clouds against
    # 16384 (bidirectional argmin, residual gathers, scatters) and the
    # denoise targets at k = 64, a request at B and a step at B_TRAIN
    ocfg = options_config().model
    recipe_tables += [(B, request_calls(ocfg)), (B_TRAIN, train_step_calls(ocfg))]
    for name in ("knn", "fps", "gather_rows", "nn_bidir_argmin", "scatter_add_rows"):
        extra[name] += [(b, c) for b, table in recipe_tables for c in table.get(name) or []]
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
    # the deformable gather around the grouped 3-NN, at the request's calls
    k_deform = int(dcfg.encoder_config.k)
    require(k_deform == int(dcfg.decoder_config.k), "the deformable config's encoder and decoder k differ")
    grouped_gather = time_grouped_gather([(B, c) for c in check_calls["three_nn_interpolate"]], k_deform, g, dev)

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

    # ---- phase 8: the PCN, ShapeNet-55 and KITTI recipes from trees on disk
    recipe_counts, recipes_summary = recipes_phase(args.seed, dev, card)
    counts.update(recipe_counts)

    # ---- phase 9: the five PCN baselines, and gradient accumulation
    baseline_counts, baselines_summary = baselines_phase(args.seed, dev, card)
    counts.update(baseline_counts)

    # ---- phase 10: the entry points (the CLI, PCReconstructor, --profile, --worker_mode, writers)
    entry_counts, entry_summary = entry_points_phase(args.seed, dev, card,
                                                     recipes_summary["shapenet55"]["median_step_ms"])
    counts.update(entry_counts)

    # ---- phase 11: the options no shipped config sets
    options_counts, options_summary = options_phase(args.seed, dev, card)
    counts.update(options_counts)

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
            "launches_per_options_request": counts["options_request"][name] // REQUESTS,
            "launches_per_options_train_step": counts["options_train"][name] // TRAIN_STEPS,
            "launches_options_validate": counts["options_validate"][name],
            "launches_per_options_deform_train_step": counts["options_deform_train"][name] // TRAIN_STEPS,
            "launches_validate": counts["validate"][name], "launches_test": counts["test"][name],
            "launches_validate_mxu": counts["validate_mxu"][name],
            "launches_test_mxu": counts["test_mxu"][name],
            "launches_per_pcn_train_step": counts["pcn_train"][name] // TRAIN_STEPS,
            "launches_per_shapenet55_train_step": counts["shapenet_train"][name] // TRAIN_STEPS,
            "launches_per_kitti_train_step": counts["kitti_train"][name] // TRAIN_STEPS,
            "launches_shapenet55_test_batch": {m: counts[f"shapenet_test_{m}"][name] // (EVAL_CLOUDS // B_VAL)
                                               for m in port_runner.CROP_RATIO},
            "launches_per_cli_request": counts["cli"][name] // entry_summary["cli"]["files"],
            "launches_per_reconstructor_request": {
                "flagship": counts["reconstructor_flagship"][name],
                "superset": counts["reconstructor_superset"][name] // REQUESTS},
            "launches_baselines": {b: {"request": counts[f"{b}_request"][name] // REQUESTS,
                                       "train_step": counts[f"{b}_train"][name] // BASELINE_STEPS,
                                       "validate": counts[f"{b}_validate"][name], "test": counts[f"{b}_test"][name]}
                                   for b in BASELINES},
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": t["library_ms"],
            # the kernels timed by graph replay: their host-loop times too
            **{k: t[k] for k in ("loop_ms", "library_loop_ms", "host_us", "ms_live_small",
                                 "loop_ms_live_small", "live_small") if k in t},
            **t.get("more", {}),
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
                                  "deform": deform_summary | {"grouped_deform_gather": grouped_gather},
                                  "recipes": recipes_summary, "baselines": baselines_summary,
                                  "entry_points": entry_summary, "options": options_summary}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
