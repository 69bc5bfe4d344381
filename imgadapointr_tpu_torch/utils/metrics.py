"""Evaluation metrics: CD-L1, CD-L2 (both x1000) and F-Score@0.01.

Counterpart of ``imgadapointr_tpu/utils/metrics.py:35-96``. All three come
from one bidirectional nearest-neighbour pass (:func:`ops.nn_distance_eval`).
"""

from __future__ import annotations

import torch

from ..ops import nn_distance_eval


def _f_from_hits(s1: torch.Tensor, s2: torch.Tensor, th: float) -> torch.Tensor:
    # hit rates in float32 whatever the distances' type, as the JAX package
    # counts them (metrics.py:59, :90)
    precision = (s1 < th).float().mean(dim=1)
    recall = (s2 < th).float().mean(dim=1)
    denom = precision + recall
    f = 2.0 * precision * recall / denom.clamp_min(1e-12)
    return torch.where(denom > 0, f, torch.zeros_like(f))


def f_score(pred: torch.Tensor, gt: torch.Tensor, th: float = 0.01,
            reduce: bool = True) -> torch.Tensor:
    """what3d F-Score@th: precision = mean(d(pred->gt) < th), recall =
    mean(d(gt->pred) < th), F = 2PR/(P+R). Batch mean, or per sample (B,)
    with ``reduce=False``."""
    d1, d2, _, _ = nn_distance_eval(pred, gt)
    f = _f_from_hits(d1.clamp_min(0.0).sqrt(), d2.clamp_min(0.0).sqrt(), th)
    return f.mean() if reduce else f


def eval_metric_suite(pred: torch.Tensor, gt: torch.Tensor, th: float = 0.01,
                      reduce: bool = True):
    """(f_score, cd_l1 x1000, cd_l2 x1000) from ONE nearest-neighbour pass.
    Batch means, or per-sample (B,) vectors with ``reduce=False``."""
    d1, d2, _, _ = nn_distance_eval(pred, gt)
    s1 = torch.sqrt(d1.clamp_min(1e-24))  # same floor as chamfer_l1
    s2 = torch.sqrt(d2.clamp_min(1e-24))
    cd_l1 = (s1.mean(dim=1) + s2.mean(dim=1)) / 2.0 * 1000.0
    cd_l2 = (d1.mean(dim=1) + d2.mean(dim=1)) * 1000.0
    f = _f_from_hits(s1, s2, th)
    if reduce:
        return f.mean(), cd_l1.mean(), cd_l2.mean()
    return f, cd_l1, cd_l2
