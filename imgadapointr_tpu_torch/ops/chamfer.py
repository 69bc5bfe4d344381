"""Chamfer distance, forward only (eval metrics and loss values).

Counterpart of ``imgadapointr_tpu/ops/chamfer.py:220-278`` and ``:341-450``.
The nearest-neighbour indices of both directions come from one
bidirectional argmin, :func:`nn_bidir_argmin` (kernel
``csrc/nn_bidir_argmin.cu``, plain version :func:`nn_bidir_argmin_plain`);
the distances are then recomputed from those indices in diff form, through
the row-gather kernel, as the JAX package does (``chamfer.py:270-273``).

The autograd Function with the scatter-add backward is part of the
training slice (ROADMAP Queue 1); until it lands, the loss forms
raise on inputs that require a gradient.
"""

from __future__ import annotations

import torch

from . import _build
from .pointops import _on_cpu, index_points, sqdist

_TRAINING_SLICE = (
    "the chamfer backward (scatter-add kernel and autograd Function) is part "
    "of the training slice (ROADMAP Queue 1)"
)
# plain version: elements of one (B, N, tile, 3) difference block
_PLAIN_BLOCK = 1 << 26


def _nn_one_direction_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """First-index argmin over y of the diff-form distance, for every x;
    tiled over M like ``chamfer._nn_one_direction(..., diff_form=True)``."""
    B, N, _ = x.shape
    M = y.shape[1]
    tile = max(1, min(M, _PLAIN_BLOCK // max(1, B * N * 3)))
    best_d = torch.full((B, N), float("inf"), dtype=x.dtype, device=x.device)
    best_i = torch.zeros(B, N, dtype=torch.int64, device=x.device)
    for base in range(0, M, tile):
        d = sqdist(x[:, :, None, :] - y[:, None, base : base + tile, :])
        amin = d.argmin(dim=-1)  # first minimum within the tile
        dmin = d.gather(-1, amin[..., None])[..., 0]
        upd = dmin < best_d  # strict: an earlier tile keeps its tie
        best_d = torch.where(upd, dmin, best_d)
        best_i = torch.where(upd, amin + base, best_i)
    return best_i


def nn_bidir_argmin_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain version of :func:`nn_bidir_argmin`: one pass per direction."""
    return _nn_one_direction_plain(x, y), _nn_one_direction_plain(y, x)


def nn_bidir_argmin(x: torch.Tensor, y: torch.Tensor):
    """(i1 (B, N), i2 (B, M)) int64: the nearest y for every x and the
    nearest x for every y, by diff-form squared distance, first index on
    ties."""
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"nn_bidir_argmin: x (B, N, 3) and y (B, M, 3) expected, got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.shape[1] == 0 or y.shape[1] == 0:
        raise ValueError("nn_bidir_argmin: empty cloud")
    if _on_cpu("nn_bidir_argmin", x):
        return nn_bidir_argmin_plain(x, y)
    _build.require_cuda_f32("nn_bidir_argmin", x.device, x, y, last_dim=3)
    B, N, _ = x.shape
    M = y.shape[1]
    i1 = torch.empty(B, N, dtype=torch.int64, device=x.device)
    i2 = torch.empty(B, M, dtype=torch.int64, device=x.device)
    _build.launch(
        "nn_bidir_argmin", "nn_bidir_argmin_f32", x.device,
        x.data_ptr(), y.data_ptr(), i1.data_ptr(), i2.data_ptr(), B, N, M,
    )
    return i1, i2


def nn_distance(x: torch.Tensor, y: torch.Tensor):
    """(d1 (B, N), d2 (B, M), i1, i2): squared NN distances and indices in
    both directions. Forward only: raises on inputs that need a gradient."""
    if x.requires_grad or y.requires_grad:
        raise NotImplementedError(_TRAINING_SLICE)
    i1, i2 = nn_bidir_argmin(x, y)
    d1 = sqdist(x - index_points(y, i1)).clamp_min(0.0)
    d2 = sqdist(y - index_points(x, i2)).clamp_min(0.0)
    return d1, d2, i1, i2


def nn_distance_eval(x: torch.Tensor, y: torch.Tensor):
    """:func:`nn_distance` for EVAL METRICS ONLY; non-differentiable by
    design (the inputs are detached, as the JAX version stops gradients)."""
    return nn_distance(x.detach(), y.detach())


def chamfer_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CD-L1: ``(mean(sqrt(d1)) + mean(sqrt(d2))) / 2``, forward only."""
    d1, d2, _, _ = nn_distance(x, y)
    s1 = torch.sqrt(d1.clamp_min(1e-24))
    s2 = torch.sqrt(d2.clamp_min(1e-24))
    return (s1.mean() + s2.mean()) / 2.0


def chamfer_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CD-L2: ``mean(d1) + mean(d2)``, forward only."""
    d1, d2, _, _ = nn_distance(x, y)
    return d1.mean() + d2.mean()
