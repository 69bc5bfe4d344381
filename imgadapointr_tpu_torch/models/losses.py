"""Loss functions of the model zoo.

Counterpart of ``imgadapointr_tpu/models/losses.py:18-42``: the denoise
CD-L1 on kNN-gathered targets, times 0.5, and the reconstruction loss
CD-L1(coarse) + CD-L1(fine). ``cycle_alpha`` (the variable-loss schedule)
waits for the superset's training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

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
