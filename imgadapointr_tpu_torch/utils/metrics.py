"""Evaluation metrics: CD-L1, CD-L2 (both x1000) and F-Score@0.01.

Counterpart of ``imgadapointr_tpu/utils/metrics.py``.
:func:`eval_metric_suite` takes all three from one bidirectional
nearest-neighbour pass (:func:`ops.nn_distance_eval`, which may select by
the opt-in matmul-form kernel); :func:`f_score` alone always takes the exact
:func:`ops.nn_distance`. :func:`compute_metrics` is the test protocol's
table row, whose CDs can drop zero-padded rows, with the auction EMD
(:func:`ops.emd_distance_metric`) where it is asked for;
:func:`compute_metrics_per_sample` gives one such row per sample.
"""

from __future__ import annotations

import torch

from ..ops import emd_auction, emd_distance_metric, nn_distance, nn_distance_eval
from ..ops.chamfer import _masked_mean, _sqrt_floor

METRIC_NAMES = ["F-Score", "CDL1", "CDL2", "EMDistance"]
# whether a greater value of the metric is better
METRIC_SIGNS = {"F-Score": True, "CDL1": False, "CDL2": False, "EMDistance": False}


def _nonzero_mask(cloud: torch.Tensor) -> torch.Tensor:
    """(B, N) mask of the cloud's dtype: 1 for real rows, 0 for zero-padded
    rows, by the reference's signed test ``sum(xyz) != 0`` (a real point
    whose coordinates sum to zero is dropped there, so it is here)."""
    return (cloud.sum(dim=-1) != 0).to(cloud.dtype)


def _f_from_rates(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    denom = precision + recall
    f = 2.0 * precision * recall / denom.clamp_min(1e-12)
    return torch.where(denom > 0, f, torch.zeros_like(f))


def _hit_rate(dist: torch.Tensor, th: float, w: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample share of ``dist`` below ``th`` (of the rows ``w`` marks
    valid), in float32 whatever the distances' type, as the JAX package
    counts them (metrics.py:58-62, :90)."""
    hits = (dist < th).float()
    if w is None:
        return hits.mean(dim=1)
    w = w.float()
    return (hits * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)


def f_score(pred: torch.Tensor, gt: torch.Tensor, th: float = 0.01,
            w_pred: torch.Tensor | None = None, w_gt: torch.Tensor | None = None,
            reduce: bool = True) -> torch.Tensor:
    """what3d F-Score@th: precision = share of pred with d(pred->gt) < th,
    recall = share of gt with d(gt->pred) < th, F = 2PR/(P+R), from the
    exact :func:`ops.nn_distance` (never the opt-in selection of
    :func:`ops.nn_distance_eval`). The optional (B, N) / (B, M) masks drop
    rows from the hit counts and from the neighbour candidates. Batch mean,
    or per sample (B,) with ``reduce=False``."""
    d1, d2, _, _ = nn_distance(pred.detach(), gt.detach(), w_pred, w_gt)
    f = _f_from_rates(_hit_rate(d1.clamp_min(0.0).sqrt(), th, w_pred),
                      _hit_rate(d2.clamp_min(0.0).sqrt(), th, w_gt))
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
    f = _f_from_rates(_hit_rate(s1, th), _hit_rate(s2, th))
    if reduce:
        return f.mean(), cd_l1.mean(), cd_l2.mean()
    return f, cd_l1, cd_l2


def compute_metrics(pred: torch.Tensor, gt: torch.Tensor, require_emd: bool = False,
                    ignore_zeros: bool = False):
    """[F-Score, CDL1 x1000, CDL2 x1000, EMD x1000] of the test protocol
    (``imgadapointr_tpu/utils/metrics.py:99-144``); EMD is 0 unless
    ``require_emd``.

    ``ignore_zeros`` drops zero-padded rows of either cloud from the CD
    means and from the neighbour candidates, as the reference's eval
    objects do at batch size 1; the F-Score (the exact :func:`f_score`)
    and EMD never strip zeros."""
    w_pred = _nonzero_mask(pred) if ignore_zeros else None
    w_gt = _nonzero_mask(gt) if ignore_zeros else None
    d1, d2, _, _ = nn_distance(pred.detach(), gt.detach(), w_pred, w_gt)
    cd_l1 = (_masked_mean(_sqrt_floor(d1), w_pred) + _masked_mean(_sqrt_floor(d2), w_gt)) / 2.0
    cd_l2 = _masked_mean(d1, w_pred) + _masked_mean(d2, w_gt)
    f = f_score(pred, gt)
    emd = emd_distance_metric(pred, gt) * 1000.0 if require_emd else torch.zeros_like(cd_l1)
    return [f, cd_l1 * 1000.0, cd_l2 * 1000.0, emd.to(cd_l1.dtype)]


def _per_sample_mean(v: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """(B,) mean over each row of ``v`` (B, N), of the entries ``w`` marks
    valid where given."""
    if w is None:
        return v.mean(dim=1)
    w = w.to(v.dtype)
    return (v * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)


def compute_metrics_per_sample(pred: torch.Tensor, gt: torch.Tensor, require_emd: bool = False,
                               ignore_zeros: bool = False) -> torch.Tensor:
    """(B, 4) rows [F-Score, CDL1 x1000, CDL2 x1000, EMD x1000]
    (``imgadapointr_tpu/utils/metrics.py:147-191``): row ``b`` equals
    ``compute_metrics(pred[b:b+1], gt[b:b+1], ...)``, so each row is one
    batch-1 evaluation, with its own ``ignore_zeros`` masks. F is the exact
    per-sample :func:`f_score`; EMD (the auction, eps 0.005, 100
    iterations) is per sample, 0 unless ``require_emd``."""
    pred, gt = pred.detach(), gt.detach()
    w_pred = _nonzero_mask(pred) if ignore_zeros else None
    w_gt = _nonzero_mask(gt) if ignore_zeros else None
    d1, d2, _, _ = nn_distance(pred, gt, w_pred, w_gt)
    cd_l1 = (_per_sample_mean(_sqrt_floor(d1), w_pred) + _per_sample_mean(_sqrt_floor(d2), w_gt)) / 2.0
    cd_l2 = _per_sample_mean(d1, w_pred) + _per_sample_mean(d2, w_gt)
    f = f_score(pred, gt, reduce=False).to(cd_l1.dtype)
    if require_emd:
        dist, _ = emd_auction(pred, gt, 0.005, 100)
        emd = dist.clamp_min(0.0).sqrt().mean(dim=1).to(cd_l1.dtype) * 1000.0
    else:
        emd = torch.zeros_like(cd_l1)
    return torch.stack([f, cd_l1 * 1000.0, cd_l2 * 1000.0, emd], dim=1)


class Metrics:
    """The metric values of one evaluation, compared on the considered
    metric (reference utils/metrics.py:118-165)."""

    def __init__(self, metric_name: str, values):
        if metric_name not in METRIC_NAMES:
            raise ValueError(f"unknown metric {metric_name}")
        self.metric_name = metric_name
        if isinstance(values, dict):
            self._values = {k: float(v) for k, v in values.items()}
        else:
            self._values = {n: float(v) for n, v in zip(METRIC_NAMES, values)}

    def state_dict(self) -> dict:
        return dict(self._values)

    def value(self) -> float:
        return self._values[self.metric_name]

    def better_than(self, other: "Metrics | None") -> bool:
        if other is None:
            return True
        if METRIC_SIGNS[self.metric_name]:
            return self.value() > other.value()
        return self.value() < other.value()

    def __repr__(self):
        return f"Metrics({self.metric_name}, {self._values})"
