"""Loss functions of the model zoo.

Counterpart of ``imgadapointr_tpu/models/losses.py:18-59``: the denoise
CD-L1 on kNN-gathered targets, times 0.5, and the reconstruction loss
alpha · CD-L1(coarse) + CD-L1(fine), with alpha 1 (AdaPoinTr) or the
variable-loss schedule :func:`variable_alpha` of the float epoch.
"""

from __future__ import annotations

import math

import torch

from ..ops import chamfer_l1, index_points, knn_point


def denoise_targets(gt: torch.Tensor, denoised_coarse: torch.Tensor, factor: int) -> torch.Tensor:
    """Ground-truth targets of the denoise task: the ``factor`` nearest gt
    points of every denoise query, (B, L * factor, 3) (reference
    AdaPoinTr.py:201-205). Constants: no gradient flows into them."""
    with torch.no_grad():
        idx = knn_point(factor, gt, denoised_coarse.contiguous())  # (B, L, factor)
        return index_points(gt, idx).reshape(gt.shape[0], -1, 3)


def adapointr_loss(ret, gt: torch.Tensor, factor: int, coarse_alpha: float = 1.0):
    """``(loss_denoised, loss_recon)`` of the train-mode return ``ret``.
    ``coarse_alpha`` = 1 is AdaPoinTr's plain loss."""
    pred_coarse, denoised_coarse, denoised_fine, pred_fine = ret
    target = denoise_targets(gt, denoised_coarse, factor)
    loss_denoised = 0.5 * chamfer_l1(denoised_fine, target)
    loss_recon = coarse_alpha * chamfer_l1(pred_coarse, gt) + chamfer_l1(pred_fine, gt)
    return loss_denoised, loss_recon


def cycle_alpha(epoch: float, step_size: float = 5, max_lr: float = 1.0, base_lr: float = 0.01,
                gamma: float = 0.995) -> float:
    """The CycleLR value the variable loss uses as its coarse alpha
    (reference ``models/base_blocks.py:771-783``), in float64."""
    e = float(epoch)
    cycle = math.floor(1.0 + e / (2 * step_size))
    x = abs(e / step_size - 2 * cycle + 1)
    return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) * gamma**e


ALPHA_STEP_SIZE = 5  # the reference's alpha table is CycleLR shifted by this


def variable_alpha(epoch: float) -> float:
    """The variable loss's coarse alpha at the float epoch ``epoch``
    (``imgadapointr_tpu/models/img_adapointr.py:24-29``)."""
    return cycle_alpha(epoch + ALPHA_STEP_SIZE)
