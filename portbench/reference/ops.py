"""Plain geometry ops of the reference: dense diff-form distances, stable
sorts, a loop for FPS, ``torch.gather`` for every gather, and autograd for
every backward.

Frozen copies of the plain versions that sit beside the port's kernels
(``imgadapointr_tpu_torch/ops/pointops.py``: ``sqdist``, ``knn_plain``,
``fps_plain``, ``gather_rows_plain``; ``ops/chamfer.py``: CD-L1;
``ops/gather_sum.py``: ``weighted_gather_sum_plain``; ``ops/normals.py``;
``ops/sampling.py:jitter_points``). The selection contract is the port's:
kNN and FPS rank by ``(dx*dx + dy*dy) + dz*dz`` and break ties on the first
index. The large searches run in blocks of query rows so that they fit
beside the model at the benchmark's sizes.
"""

from __future__ import annotations

import math

import torch

ROW_BLOCK = 256  # query rows of one block of a dense search


def sqdist(diff: torch.Tensor) -> torch.Tensor:
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return dx * dx + dy * dy + dz * dz


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = points[b, idx[b, ...]]`` for idx (B, S) or (B, S, K)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(B, idx[0].numel(), C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


@torch.no_grad()
def knn(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, k) indices of the k nearest points of ``xyz`` to each query."""
    out = []
    for s in range(0, new_xyz.shape[1], ROW_BLOCK):
        d = sqdist(new_xyz[:, s:s + ROW_BLOCK, None, :] - xyz[:, None, :, :])
        out.append(torch.sort(d, dim=-1, stable=True).indices[..., :k])
    return torch.cat(out, dim=1)


@torch.no_grad()
def nearest(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) index of the nearest point of ``y`` to each point of ``x``."""
    out = []
    for s in range(0, x.shape[1], ROW_BLOCK):
        out.append(torch.argmin(sqdist(x[:, s:s + ROW_BLOCK, None, :] - y[:, None, :, :]), dim=-1))
    return torch.cat(out, dim=1)


@torch.no_grad()
def fps_indices(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    out = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        mind = torch.minimum(mind, sqdist(xyz - xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=-1)
        out[:, i] = last
    return out


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    return index_points(xyz, fps_indices(xyz, npoint))


def jitter(pc: torch.Tensor, noise: torch.Tensor, std: float = 0.01, clip: float = 0.05) -> torch.Tensor:
    return pc + (std * noise).clamp(-clip, clip)


def chamfer_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CD-L1 ``(mean sqrt d1 + mean sqrt d2) / 2`` with autograd's backward."""
    d1 = sqdist(x - index_points(y, nearest(x, y))).clamp_min(0.0)
    d2 = sqdist(y - index_points(x, nearest(y, x))).clamp_min(0.0)
    return (torch.sqrt(d1.clamp_min(1e-24)).mean() + torch.sqrt(d2.clamp_min(1e-24)).mean()) / 2.0


def weighted_gather_sum(w: torch.Tensor, idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """``out[b, s] = Σ_k w[b, s, k] feats[b, idx[b, s, k]]`` (every index in range)."""
    return (w[..., None] * index_points(feats, idx)).sum(dim=2)


def _smallest_eigvec_sym3x3(A: torch.Tensor) -> torch.Tensor:
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0 + 1e-6, 1.0 - 1e-6)
    lam_min = q + 2.0 * p * torch.cos(torch.arccos(r) / 3.0 + 2.0 * math.pi / 3.0)
    m = A - lam_min[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01, c02, c12 = (torch.linalg.cross(r0, r1, dim=-1), torch.linalg.cross(r0, r2, dim=-1),
                     torch.linalg.cross(r1, r2, dim=-1))
    n01, n02, n12 = (c01 * c01).sum(-1), (c02 * c02).sum(-1), (c12 * c12).sum(-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    norm = torch.sqrt(torch.clamp((best * best).sum(dim=-1, keepdim=True), min=1e-30))
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    degenerate = (norm[..., 0] < 1e-12) | (p < 1e-12)
    return torch.where(degenerate[..., None], fallback, best / norm)


def normals(points: torch.Tensor, k: int = 30) -> torch.Tensor:
    """(B, N, 3) unit normals from the covariance of each point's k nearest
    points (self included), sign not disambiguated (pytorch3d's
    ``estimate_pointcloud_normals``, closed-form 3x3 eigenvector)."""
    k = min(k, points.shape[1])
    nbr = index_points(points, knn(k, points, points))
    d = nbr - nbr.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnki,bnkj->bnij", d, d) / k
    return _smallest_eigvec_sym3x3(cov)
