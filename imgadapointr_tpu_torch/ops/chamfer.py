"""Chamfer distance with its backward (losses and eval metrics).

Counterpart of ``imgadapointr_tpu/ops/chamfer.py:196-388``.
:func:`nn_distance` is a ``torch.autograd.Function``. Its forward takes the
nearest-neighbour indices of both directions from one bidirectional argmin,
:func:`nn_bidir_argmin` (kernel ``csrc/nn_bidir_argmin.cu``), when neither
cloud carries a validity mask and both hold at most 2^18 points, else from
two :func:`nn_one_direction` calls (kernel ``csrc/nn_one_direction.cu``,
which takes the mask); the distances are then recomputed from those
indices in diff form, through the row-gather kernel, as the JAX package
does (``chamfer.py:270-273``). Its backward adds each point's own term and
the cross term scattered from the other cloud
(:func:`~.pointops.scatter_add_rows`, kernel ``csrc/scatter_add_rows.cu``).
Each kernel has its plain PyTorch version beside its wrapper.
"""

from __future__ import annotations

import torch

from . import _build
from .pointops import _on_cpu, index_points, scatter_add_rows, sqdist

# plain version: elements of one (B, N, tile, 3) difference block
_PLAIN_BLOCK = 1 << 26
# the bidirectional kernel's cloud-size limit (chamfer.py:239-240)
_BIDIR_MAX_POINTS = 1 << 18


def nn_one_direction_plain(x: torch.Tensor, y: torch.Tensor,
                           wy: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`nn_one_direction`: the first-index argmin
    over y of the diff-form distance, for every x; tiled over M like
    ``chamfer._nn_one_direction(..., diff_form=True)``. ``wy`` (B, M) marks
    the valid y (> 0); an invalid y never wins."""
    B, N, _ = x.shape
    M = y.shape[1]
    tile = max(1, min(M, _PLAIN_BLOCK // max(1, B * N * 3)))
    best_d = torch.full((B, N), float("inf"), dtype=x.dtype, device=x.device)
    best_i = torch.zeros(B, N, dtype=torch.int64, device=x.device)
    for base in range(0, M, tile):
        d = sqdist(x[:, :, None, :] - y[:, None, base : base + tile, :])
        if wy is not None:
            d = d.masked_fill(~(wy[:, None, base : base + tile] > 0), float("inf"))
        amin = d.argmin(dim=-1)  # first minimum within the tile
        dmin = d.gather(-1, amin[..., None])[..., 0]
        upd = dmin < best_d  # strict: an earlier tile keeps its tie
        best_d = torch.where(upd, dmin, best_d)
        best_i = torch.where(upd, amin + base, best_i)
    return best_i


def _check_clouds(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"{name}: x (B, N, 3) and y (B, M, 3) expected, got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.shape[1] == 0 or y.shape[1] == 0:
        raise ValueError(f"{name}: empty cloud")


def nn_one_direction(x: torch.Tensor, y: torch.Tensor,
                     wy: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) int64: for every x the nearest valid y, by diff-form squared
    distance, first index on ties. ``wy`` (B, M), same dtype as the clouds,
    marks the valid y (> 0); a row with no valid y keeps index 0."""
    _check_clouds("nn_one_direction", x, y)
    if wy is not None and wy.shape != y.shape[:2]:
        raise ValueError(f"nn_one_direction: mask {tuple(wy.shape)} for y {tuple(y.shape)}")
    if _on_cpu("nn_one_direction", x):
        return nn_one_direction_plain(x, y, wy)
    _build.require_cuda_f32("nn_one_direction", x.device, x, y, last_dim=3)
    if wy is not None:
        _build.require_cuda_f32("nn_one_direction", x.device, wy, ndim=2)
    B, N, _ = x.shape
    idx = torch.empty(B, N, dtype=torch.int64, device=x.device)
    _build.launch(
        "nn_one_direction", "nn_one_direction_f32", x.device,
        x.data_ptr(), y.data_ptr(), None if wy is None else wy.data_ptr(),
        idx.data_ptr(), B, N, y.shape[1],
    )
    return idx


def nn_bidir_argmin_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain version of :func:`nn_bidir_argmin`: one pass per direction."""
    return nn_one_direction_plain(x, y), nn_one_direction_plain(y, x)


def nn_bidir_argmin(x: torch.Tensor, y: torch.Tensor):
    """(i1 (B, N), i2 (B, M)) int64: the nearest y for every x and the
    nearest x for every y, by diff-form squared distance, first index on
    ties."""
    _check_clouds("nn_bidir_argmin", x, y)
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


class _NNDistance(torch.autograd.Function):
    """Forward and backward of :func:`nn_distance`
    (``chamfer.py:220-335``)."""

    @staticmethod
    def forward(ctx, x, y, w1, w2):
        x, y = x.contiguous(), y.contiguous()
        if (w1 is None and w2 is None
                and x.shape[1] <= _BIDIR_MAX_POINTS and y.shape[1] <= _BIDIR_MAX_POINTS):
            i1, i2 = nn_bidir_argmin(x, y)
        else:
            i1 = nn_one_direction(x, y, w2)
            i2 = nn_one_direction(y, x, w1)
        y_at_i1 = index_points(y, i1)
        x_at_i2 = index_points(x, i2)
        d1 = sqdist(x - y_at_i1).clamp_min(0.0)
        d2 = sqdist(y - x_at_i2).clamp_min(0.0)
        if w1 is not None:
            d1 = d1 * w1
        if w2 is not None:
            d2 = d2 * w2
        ctx.save_for_backward(x, y, w1, w2, i1, i2, y_at_i1, x_at_i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g1, g2, _i1, _i2):
        x, y, w1, w2, i1, i2, y_at_i1, x_at_i2 = ctx.saved_tensors
        if w1 is not None:
            g1 = g1 * w1
        if w2 is not None:
            g2 = g2 * w2
        # d1 = |x - y[i1]|^2: d/dx = 2 (x - y[i1]) g1, and y[i1] gets minus that
        gx_own = 2.0 * (x - y_at_i1) * g1[..., None]
        gy_own = 2.0 * (y - x_at_i2) * g2[..., None]
        # a cloud that needs no gradient (a ground truth) costs no scatter
        need_x, need_y = ctx.needs_input_grad[:2]
        gx = gx_own + scatter_add_rows(x.shape[1], i2, -gy_own) if need_x else None
        gy = gy_own + scatter_add_rows(y.shape[1], i1, -gx_own) if need_y else None
        return gx, gy, None, None


def nn_distance(x: torch.Tensor, y: torch.Tensor, w1: torch.Tensor | None = None,
                w2: torch.Tensor | None = None):
    """(d1 (B, N), d2 (B, M), i1, i2): squared nearest-neighbour distances
    and int64 indices in both directions, differentiable in x and y.

    ``w1`` (B, N) / ``w2`` (B, M) are optional validity masks of the
    clouds' dtype: an invalid row gets distance 0 and no gradient, and is
    no neighbour candidate for the other cloud."""
    _check_clouds("nn_distance", x, y)
    return _NNDistance.apply(x, y, w1, w2)


def nn_distance_eval(x: torch.Tensor, y: torch.Tensor):
    """:func:`nn_distance` for EVAL METRICS ONLY; non-differentiable by
    design (the inputs are detached, as the JAX version stops gradients)."""
    return nn_distance(x.detach(), y.detach())


def _masked_mean(v: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    if w is None:
        return v.mean()
    w = w.to(v.dtype)
    return (v * w).sum() / w.sum().clamp_min(1.0)


def _sqrt_floor(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d.clamp_min(1e-24))


def chamfer_l1(x, y, w1=None, w2=None) -> torch.Tensor:
    """CD-L1: ``(mean(sqrt(d1)) + mean(sqrt(d2))) / 2``; with masks each
    mean divides by the number of valid points."""
    d1, d2, _, _ = nn_distance(x, y, w1, w2)
    return (_masked_mean(_sqrt_floor(d1), w1) + _masked_mean(_sqrt_floor(d2), w2)) / 2.0


def chamfer_l2(x, y, w1=None, w2=None) -> torch.Tensor:
    """CD-L2: ``mean(d1) + mean(d2)``."""
    d1, d2, _, _ = nn_distance(x, y, w1, w2)
    return _masked_mean(d1, w1) + _masked_mean(d2, w2)


def chamfer_l2_split(x, y, w1=None, w2=None):
    """Split CD-L2: ``(mean(d1), mean(d2))``."""
    d1, d2, _, _ = nn_distance(x, y, w1, w2)
    return _masked_mean(d1, w1), _masked_mean(d2, w2)


def chamfer_l1_pm(x, y, w1=None, w2=None) -> torch.Tensor:
    """One-sided (partial-matching) CD-L1: ``mean(sqrt(d1))``."""
    d1, _, _, _ = nn_distance(x, y, w1, w2)
    return _masked_mean(_sqrt_floor(d1), w1)
