"""PyTorch + CUDA port of imgadapointr_tpu for NVIDIA Hopper (H100).

The JAX package ``imgadapointr_tpu`` stays the reference; this package
imports nothing of it (and no JAX). Layout mirrors it: ``ops/`` (geometry
ops, each kernel-backed op with a plain PyTorch version beside it),
``csrc/`` (the hand-written CUDA kernels, built at first use by
``ops/_build.py``), ``nn/``, ``models/``, ``utils/``, ``datasets/``,
``tools/``. Ported so far: the flagship AdaPoinTr's serving path with the
eval metrics, and its training path (losses, backward, AdamW, schedules,
checkpoints, the train / validate / test runner; entry point ``main.py``);
the eval path of the image and segmentation models (ImgAdaPoinTr,
SegEncAdaPoinTr and the superset ImgEncSegDecAdaPoinTrVariableLoss).
"""
