"""PyTorch + CUDA port of imgadapointr_tpu for NVIDIA Hopper (H100).

The JAX package ``imgadapointr_tpu`` stays the reference; this package
imports nothing of it (and no JAX). Layout mirrors it: ``ops/`` (geometry
ops, each kernel-backed op with a plain PyTorch version beside it),
``csrc/`` (the hand-written CUDA kernels, built at first use by
``ops/_build.py``), ``nn/``, ``models/``, ``utils/``, ``datasets/``,
``tools/``. This slice covers the AdaPoinTr serving path in eval mode and
the eval metrics.
"""
