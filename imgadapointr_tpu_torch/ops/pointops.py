"""Point-cloud geometry ops: row gather, kNN, farthest point sampling.

Counterparts of ``imgadapointr_tpu/ops/pointops.py`` in batch-last (B, N, C)
layout. Each of the three kernels has a wrapper and a plain PyTorch
version of the same function beside it:

- :func:`gather_rows` / :func:`gather_rows_plain` (``csrc/gather_rows.cu``)
- :func:`knn_with_distance` / :func:`knn_plain` (``csrc/knn.cu``)
- :func:`furthest_point_sample` / :func:`fps_plain` (``csrc/fps.cu``)

A wrapper launches its kernel for a CUDA tensor and raises on a dtype,
shape or contiguity the kernel does not take; it takes the plain version
only for a tensor on the CPU (the parity tests, float32 or float64). There
is no fallback from the kernel to the plain version.

Selection contract (``imgadapointr_tpu/ops/pallas/nn_distance.py:17-24``):
kNN and FPS rank by the diff-form squared distance ``(dx*dx + dy*dy) +
dz*dz`` and break ties on the first index; never by the matmul form or
``torch.cdist``. Indices are int64.
"""

from __future__ import annotations

import torch

from . import _build

KNN_MAX_K = 64


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def sqdist(diff: torch.Tensor) -> torch.Tensor:
    """(..., 3) differences -> (..., ) squared norms, summed as
    (dx*dx + dy*dy) + dz*dz: the kernels' order of operations."""
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return dx * dx + dy * dy + dz * dz


# --------------------------------------------------------------- row gather


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: clamp, then ``torch.gather``."""
    B, M, C = table.shape
    idx = idx.clamp(0, M - 1)
    return torch.gather(table, 1, idx.unsqueeze(-1).expand(B, idx.shape[1], C))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, s, :] = table[b, clamp(idx[b, s], 0, M - 1), :]``.

    table (B, M, C), idx (B, S) int64 -> (B, S, C). Out-of-range indices are
    clamped, as XLA's gather and the TPU kernel do (CLAUDE.md:97-99), where
    ``torch.gather`` would raise. No gradient yet: the scatter-add backward
    arrives with the training slice (ROADMAP Queue 1).
    """
    if table.requires_grad:
        raise NotImplementedError(
            "gather_rows has no backward yet: the scatter-add gradient is part "
            "of the training slice (ROADMAP Queue 1)"
        )
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(
            f"gather_rows: table (B, M, C) and idx (B, S) expected, got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}"
        )
    if table.shape[1] == 0:
        raise ValueError("gather_rows: empty table")
    if idx.dtype != torch.int64:
        raise TypeError(f"gather_rows: int64 indices expected, got {idx.dtype}")
    if _on_cpu("gather_rows", table):
        return gather_rows_plain(table, idx)
    _build.require_cuda_f32("gather_rows", table.device, table)
    if idx.device != table.device or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be contiguous on the table's device")
    B, M, C = table.shape
    S = idx.shape[1]
    out = torch.empty(B, S, C, dtype=table.dtype, device=table.device)
    _build.launch(
        "gather_rows", "gather_rows_f32", table.device,
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, M, S, C,
    )
    return out


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: ``out[b, ...] = points[b, idx[b, ...]]``.

    points (B, N, C); idx (B, S) or (B, S, K) -> (B, S, C) or (B, S, K, C).
    Every call goes through :func:`gather_rows`.
    """
    B = idx.shape[0]
    flat = idx.reshape(B, -1).long().contiguous()
    out = gather_rows(points.contiguous(), flat)
    return out.reshape(*idx.shape, points.shape[-1])


gather_points = index_points


# ------------------------------------------------------------------------ kNN


def knn_plain(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Plain version of :func:`knn_with_distance`: the dense diff-form
    distance matrix, then a stable ascending sort (first index on ties)."""
    d = sqdist(new_xyz[:, :, None, :] - xyz[:, None, :, :])  # (B, S, M)
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def knn_with_distance(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """(sqdist (B, S, k), idx (B, S, k) int64): the ``nsample`` nearest points
    of ``xyz`` (B, M, 3) for each query of ``new_xyz`` (B, S, 3), ascending,
    first index on ties. Non-differentiable (pointnet2 semantics)."""
    xyz = xyz.detach()
    new_xyz = new_xyz.detach()
    if xyz.dim() != 3 or new_xyz.dim() != 3 or xyz.shape[0] != new_xyz.shape[0]:
        raise ValueError(
            f"knn: xyz (B, M, 3) and new_xyz (B, S, 3) expected, got "
            f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}"
        )
    M = xyz.shape[1]
    if not 1 <= nsample <= M:
        raise ValueError(f"knn: k={nsample} outside [1, {M}]")
    if _on_cpu("knn", xyz):
        return knn_plain(nsample, xyz, new_xyz)
    if nsample > KNN_MAX_K:
        raise ValueError(f"knn: the kernel takes k <= {KNN_MAX_K}, got {nsample}")
    _build.require_cuda_f32("knn", xyz.device, xyz, new_xyz, last_dim=3)
    B, S = new_xyz.shape[:2]
    dist = torch.empty(B, S, nsample, dtype=torch.float32, device=xyz.device)
    idx = torch.empty(B, S, nsample, dtype=torch.int64, device=xyz.device)
    _build.launch(
        "knn", "knn_f32", xyz.device,
        xyz.data_ptr(), new_xyz.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        B, M, S, nsample,
    )
    return dist, idx


def knn_point(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) int64 indices of the nearest ``xyz`` per query."""
    return knn_with_distance(nsample, xyz, new_xyz)[1]


# ------------------------------------------------------ farthest point sampling


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of :func:`furthest_point_sample`: the loop of
    ``imgadapointr_tpu/ops/pointops.py:344-374`` in diff form."""
    B, N, _ = xyz.shape
    out = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        d = sqdist(xyz - xyz[rows, last][:, None, :])
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=-1)  # first maximum
        out[:, i] = last
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, npoint) int64 farthest-point indices of ``xyz`` (B, N, 3): seeded
    at index 0, running min-distance cache initialised to 1e10, first
    argmax (the pointnet2 contract). Non-differentiable."""
    xyz = xyz.detach()
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: xyz (B, N, 3) expected, got {tuple(xyz.shape)}")
    N = xyz.shape[1]
    if N < 1 or npoint < 1:
        raise ValueError(f"fps: needs N >= 1 and npoint >= 1, got N={N}, npoint={npoint}")
    if _on_cpu("fps", xyz):
        return fps_plain(xyz, npoint)
    _build.require_cuda_f32("fps", xyz.device, xyz, last_dim=3)
    max_n = _build.library().fps_max_points()
    if N > max_n:
        raise ValueError(f"fps: the kernel holds at most {max_n} points in shared memory, got {N}")
    B = xyz.shape[0]
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    _build.launch(
        "fps", "fps_f32", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N, npoint
    )
    return out


def fps(data: torch.Tensor, number: int) -> torch.Tensor:
    """FPS returning the sampled coordinates (B, number, 3)."""
    return index_points(data, furthest_point_sample(data, number))
