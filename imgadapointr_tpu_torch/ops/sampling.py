"""Stochastic point-cloud ops: the denoise jitter, the ShapeNet-55 crops,
the KITTI-finetune dropping, random subsets and scales.

Counterpart of ``imgadapointr_tpu/ops/sampling.py:15-154``. Randomness comes
from an explicit ``torch.Generator`` on the tensor's device, never from the
global state. Each op also takes its draws as arguments (``noise``,
``center``, ``num_crop``, ``keep_n``, ``scores``, ``scale``), so that a
comparison of two devices or two frameworks can hand both the same draws.

The crops rank points by their euclidean distance to a view point, computed
in one pinned order (``sqrt((dx² + dy²) + dz²)``, each operation rounded,
where the JAX package takes ``linalg.norm``) and sorted stably, so that the
card and the CPU rank alike and equal distances keep their index order.
FPS and every gather go through the kernels (``furthest_point_sample``,
``index_points``).
"""

from __future__ import annotations

import functools

import torch

from ..parallel.dist import global_draw
from .pointops import fps, furthest_point_sample, index_points


def jitter_points(pc: torch.Tensor, generator: torch.Generator | None = None,
                  std: float = 0.01, clip: float = 0.05,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """``pc + clamp(std * n, -clip, clip)`` with ``n`` standard normal, drawn
    per element from ``generator``, or ``noise`` (``pc``'s shape)."""
    if noise is None:
        noise = global_draw(torch.randn, pc.shape, generator=generator, dtype=pc.dtype, device=pc.device)
    elif noise.shape != pc.shape:
        raise ValueError(f"jitter_points: noise {tuple(noise.shape)} for points {tuple(pc.shape)}")
    return pc + (std * noise.to(device=pc.device, dtype=pc.dtype)).clamp(-clip, clip)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (size 3), summed as ``(x² + y²) + z²``.
    The root is taken in float64: PyTorch's vectorised CPU ``sqrt`` is not
    correctly rounded in float32 (the card's is), while the float64 root
    of a float32 sum rounds to the correctly rounded float32 root."""
    s = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    return torch.sqrt(s.double()).to(s.dtype)


def _unit_center(center: torch.Tensor) -> torch.Tensor:
    """A (B, 1, 3) standard-normal draw scaled to unit length."""
    return center / _norm3(center)[..., None]


def view_order(xyz: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """(B, N) indices of ``xyz`` (B, N, 3) nearest ``center`` (B, 1, 3)
    first; equal distances keep their index order."""
    return torch.argsort(_norm3(center - xyz), dim=-1, stable=True)


def separate_point_cloud(xyz: torch.Tensor, num_crop: int, fixed_point=None,
                         generator: torch.Generator | None = None, padding_zeros: bool = False,
                         center: torch.Tensor | None = None):
    """The ShapeNet-55 crop: the ``num_crop`` points of each cloud nearest a
    view point become the crop, the rest the input.

    The view point is ``fixed_point`` as given (a (3,) point, or one a
    cloud, (B, 3)), else a random unit direction: a (B, 1, 3) standard
    normal ``center`` (drawn from ``generator`` unless given) scaled to
    length 1. Returns (input (B, N - num_crop, 3), crop (B, num_crop, 3));
    with ``padding_zeros`` the input is the (B, N, 3) sorted cloud with its
    crop rows zeroed."""
    B, N, _ = xyz.shape
    if fixed_point is None:
        if center is None:
            center = global_draw(torch.randn, (B, 1, 3), generator=generator, dtype=xyz.dtype,
                                 device=xyz.device)
        center = _unit_center(center.to(device=xyz.device, dtype=xyz.dtype))
    else:
        center = torch.as_tensor(fixed_point, dtype=xyz.dtype, device=xyz.device).reshape(-1, 1, 3)
        center = center.expand(B, 1, 3)
    sorted_pts = index_points(xyz, view_order(xyz, center))
    crop = sorted_pts[:, :num_crop].contiguous()
    if padding_zeros:
        keep = (torch.arange(N, device=xyz.device) >= num_crop).to(xyz.dtype)
        return sorted_pts * keep[None, :, None], crop
    return sorted_pts[:, num_crop:].contiguous(), crop


def train_crop_kept(gt: torch.Tensor, center: torch.Tensor, num_crop: torch.Tensor) -> torch.Tensor:
    """The cloud :func:`train_random_crop` samples: ``gt`` sorted by distance
    to the unit ``center`` (B, 1, 3), its first ``num_crop`` (B, 1) rows
    replaced by copies of the farthest point."""
    sorted_pts = index_points(gt, view_order(gt, center))
    keep = torch.arange(gt.shape[1], device=gt.device)[None, :] >= num_crop.to(gt.device)
    return torch.where(keep[..., None], sorted_pts, sorted_pts[:, -1:, :])


def train_random_crop(gt: torch.Tensor, npoints: int, out_points: int = 2048,
                      generator: torch.Generator | None = None, center: torch.Tensor | None = None,
                      num_crop: torch.Tensor | None = None) -> torch.Tensor:
    """The ShapeNet-55/34 train augmentation: per cloud, the ``num_crop``
    points nearest a random unit direction are dropped and the rest FPS'd
    to ``out_points`` (``imgadapointr_tpu/ops/sampling.py:125-154``).

    Fixed shape: the dropped rows become copies of the farthest kept point,
    which FPS never picks while a distinct point is left (``num_crop`` is at
    most 3/4 of ``npoints``, so at least ``npoints / 4 >= out_points`` points
    stay). Draws, in this order, from ``generator`` unless given: ``center``
    (B, 1, 3) standard normal, then ``num_crop`` (B, 1) integers in
    [npoints / 4, 3 npoints / 4]."""
    B, N, _ = gt.shape
    if N != npoints:
        raise ValueError(f"train_random_crop: {N} points a cloud, the config says {npoints}")
    lo, hi = npoints // 4, (npoints * 3) // 4
    if center is None:
        center = global_draw(torch.randn, (B, 1, 3), generator=generator, dtype=gt.dtype, device=gt.device)
    if num_crop is None:
        num_crop = global_draw(functools.partial(torch.randint, lo, hi + 1), (B, 1), generator=generator,
                               device=gt.device)
    center = _unit_center(center.to(device=gt.device, dtype=gt.dtype))
    return fps(train_crop_kept(gt, center, num_crop), out_points)


def dropping_keep_range(epoch: int) -> tuple[int, int]:
    """[low, high) of the point count :func:`random_dropping` keeps at ``epoch``."""
    up_num = max(64, 768 // (epoch // 50 + 1))
    return 1, max(up_num, 2)


def random_dropping(pc: torch.Tensor, epoch: int, generator: torch.Generator | None = None,
                    keep_n: torch.Tensor | None = None) -> torch.Tensor:
    """The KITTI-finetune augmentation: keep the first ``keep_n`` points of
    each cloud's farthest-point order and zero the rest, at the cloud's size
    (``imgadapointr_tpu/ops/sampling.py:94-122``). ``keep_n`` is one integer
    for the batch in :func:`dropping_keep_range` of ``epoch``, drawn from
    ``generator`` unless given. Only the first ``min(N, 768)`` picks can be
    kept, so FPS runs that far."""
    B, N, _ = pc.shape
    if keep_n is None:
        keep_n = torch.randint(*dropping_keep_range(int(epoch)), (), generator=generator, device=pc.device)
    S = min(N, 768)
    spread = index_points(pc, furthest_point_sample(pc, S))
    mask = torch.arange(S, device=pc.device) < torch.as_tensor(keep_n, device=pc.device)
    spread = spread * mask[None, :, None].to(pc.dtype)
    if S < N:
        spread = torch.cat([spread, spread.new_zeros(B, N - S, 3)], dim=1)
    return spread


def random_sample(data: torch.Tensor, number: int, generator: torch.Generator | None = None,
                  scores: torch.Tensor | None = None) -> torch.Tensor:
    """``number`` distinct points of each cloud, uniformly at random: the
    top ``number`` of (B, N) uniform ``scores`` (drawn unless given)."""
    B, N, _ = data.shape
    if scores is None:
        scores = global_draw(torch.rand, (B, N), generator=generator, device=data.device)
    return index_points(data, torch.topk(scores.to(data.device), number, dim=-1).indices)


def random_scale(partial: torch.Tensor, gt: torch.Tensor, scale_range=(0.8, 1.2),
                 generator: torch.Generator | None = None, scale: torch.Tensor | float | None = None):
    """(partial, gt) times one uniform ``scale`` in ``scale_range`` (drawn unless given)."""
    if scale is None:
        lo, hi = scale_range
        scale = lo + (hi - lo) * torch.rand((), generator=generator, dtype=partial.dtype, device=partial.device)
    return partial * scale, gt * scale
