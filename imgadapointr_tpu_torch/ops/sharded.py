"""Point-axis sharded geometry ops: the point dimension of a cloud split
over the ranks of a process group.

Counterpart of ``imgadapointr_tpu/ops/sharded.py:62-389``. On a TPU the
JAX package circulates blocks of one cloud around a ``ppermute`` ring (an
ICI idiom). Over NVLink the clouds are small (B x N x 3 floats) and the
O(N * M) distance field is what must be split, so each op here all-gathers
the *coordinates* (``parallel/dist.py:all_gather``) and runs the port's
exact kernels on its own rows only:

- :func:`sharded_nn_distance`: this rank's ``N / p`` rows of ``x`` against
  all of ``y`` and its ``M / p`` rows of ``y`` against all of ``x``, by the
  one-direction argmin (``csrc/nn_one_direction.cu``, no mask). Indices are
  global; ties go to the lowest index, as the kernel breaks them. The
  distances are recomputed from the gathered winners in diff form, as JAX
  ``_nn_both_directions`` does (``:140-156``), so gradients reach both
  clouds through the gathered coordinates' adjoint. Memory per rank is
  ``O(B (N + M))`` coordinates and ``O(B (N + M) / p)`` distances: no
  ``(N, M)`` field is built.
- :func:`sharded_chamfer_l1`, :func:`sharded_chamfer_l2`: the losses, each
  mean summed over the group (an all-reduce) over the global count. The
  result is one value on every rank, and its gradient that value's: each
  rank's shard gets the gradient of the one global loss, as JAX's
  ``jax.grad`` of the ring loss gives. The runner's ``--sp`` losses hold
  both clouds whole on every rank, so they skip the all-gather and take
  each rank's share of the gradient instead
  (``ops/chamfer.py:points_axis_sharding``).
- :func:`sharded_knn`: the port's kNN kernel for this rank's queries
  against every point; ``nsample`` must be at most ``N / p`` (JAX's
  contract, ``:284-287``).
- :func:`sharded_fps`: all-gather, then one launch of the port's FPS
  kernel; the result is replicated, with JAX's lowest-index tie-break.

Inputs are this rank's contiguous slice of the point dimension (rank
``r`` of ``p`` holds rows ``r N / p .. (r + 1) N / p``); outputs stay sharded
on the point dimension like JAX's ``out_specs``, except ``sharded_fps``'s
and the losses, which are replicated. Validity masks are not taken (JAX's
contract too): a masked call uses the unsharded ops.
"""

from __future__ import annotations

import torch

from ..parallel.dist import Group, all_gather, all_reduce
from .chamfer import _sqrt_floor, nn_one_direction
from .pointops import furthest_point_sample, index_points, knn_point, sqdist


def _check_shards(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] or x.shape[-1] != 3 or y.shape[-1] != 3:
        raise ValueError(f"{name}: shards (B, N/p, 3) and (B, M/p, 3) expected, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")


def sharded_nn_distance(x: torch.Tensor, y: torch.Tensor, group: Group):
    """(d1 (B, N/p), d2 (B, M/p), i1, i2): :func:`ops.chamfer.nn_distance`
    of the whole clouds, for this rank's rows of each, with global int64
    indices; ``x`` and ``y`` are this rank's shards. Differentiable in both
    clouds."""
    _check_shards("sharded_nn_distance", x, y)
    X = all_gather(x.contiguous(), group, dim=1)
    Y = all_gather(y.contiguous(), group, dim=1)
    with torch.no_grad():
        i1 = nn_one_direction(x.detach().contiguous(), Y.detach())
        i2 = nn_one_direction(y.detach().contiguous(), X.detach())
    d1 = sqdist(x - index_points(Y, i1)).clamp_min(0.0)
    d2 = sqdist(y - index_points(X, i2)).clamp_min(0.0)
    return d1, d2, i1, i2


def _global_mean(local: torch.Tensor, group: Group, adjoint: bool) -> torch.Tensor:
    """The mean over the group of equal-shaped shards: the local sum
    all-reduced over the global count (``adjoint``: the all-reduce's
    gradient is the sum over the ranks, else the rank's own)."""
    return all_reduce(local.sum(), group, backward="sum" if adjoint else "identity") / (
        local.numel() * group.size)


def sharded_chamfer_l1(x: torch.Tensor, y: torch.Tensor, group: Group) -> torch.Tensor:
    """CD-L1 ``(mean(sqrt d1) + mean(sqrt d2)) / 2`` of the whole clouds
    whose shards the ranks hold, replicated on every rank."""
    d1, d2, _, _ = sharded_nn_distance(x, y, group)
    return (_global_mean(_sqrt_floor(d1), group, False) + _global_mean(_sqrt_floor(d2), group, False)) / 2.0


def sharded_chamfer_l2(x: torch.Tensor, y: torch.Tensor, group: Group) -> torch.Tensor:
    """CD-L2 ``mean(d1) + mean(d2)`` of the whole clouds, replicated."""
    d1, d2, _, _ = sharded_nn_distance(x, y, group)
    return _global_mean(d1, group, False) + _global_mean(d2, group, False)


def sharded_knn(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, group: Group) -> torch.Tensor:
    """(B, S/p, nsample) int64 global indices of the nearest points of the
    whole ``xyz`` for this rank's queries ``new_xyz``, ascending, first
    index on ties (:func:`ops.pointops.knn_point`). Both are shards.
    Non-differentiable."""
    _check_shards("sharded_knn", xyz, new_xyz)
    if nsample > xyz.shape[1]:
        raise ValueError(f"sharded_knn: nsample={nsample} exceeds the per-rank block {xyz.shape[1]}; "
                         "use fewer ranks or the unsharded knn_point")
    with torch.no_grad():
        X = all_gather(xyz.detach().contiguous(), group, dim=1)
        return knn_point(nsample, X, new_xyz.detach().contiguous())


def sharded_fps(xyz: torch.Tensor, npoint: int, group: Group) -> torch.Tensor:
    """(B, npoint) int64 global farthest-point indices of the whole cloud
    whose shards the ranks hold (seed index 0, first argmax on ties),
    replicated. Non-differentiable."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"sharded_fps: a shard (B, N/p, 3) expected, got {tuple(xyz.shape)}")
    with torch.no_grad():
        return furthest_point_sample(all_gather(xyz.detach().contiguous(), group, dim=1), npoint)


def shard_points(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's contiguous slice of the point dimension (dim 1) of a
    cloud every rank of ``group`` holds whole."""
    return x.chunk(group.size, dim=1)[group.rank]
