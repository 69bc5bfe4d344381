"""Per-point normals from the covariance of each point's k nearest
neighbours (self included): the eigenvector of the smallest eigenvalue.

Counterpart of ``imgadapointr_tpu/ops/normals.py:21-96`` (pytorch3d's
``estimate_pointcloud_normals`` with ``disambiguate_directions=False``, as
the reference calls it with k=30). The kNN is the kNN kernel, the
neighbours come through the row gather, and the 3x3 eigenvector is the
JAX package's closed form, not ``torch.linalg.eigh``: the sign of the
eigenvector and the degenerate cases (a clipped ``r``, the largest of three
row cross products, the +z fallback) are part of what GDANet sees.
"""

from __future__ import annotations

import math

import torch

from .pointops import index_points, knn_point


def _smallest_eigvec_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 3) unit eigenvector of the smallest
    eigenvalue: trigonometric eigenvalues, then the null space of
    ``A - λ I`` as the largest of its three pairwise row cross products."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    # strictly inside (-1, 1): the value shift is tiny and only where the
    # eigenvector is ill-defined anyway (the fallback below owns that case)
    r = torch.clamp(detB / 2.0, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    m = A - lam_min[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = (c01 * c01).sum(dim=-1)
    n02 = (c02 * c02).sum(dim=-1)
    n12 = (c12 * c12).sum(dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    norm = torch.sqrt(torch.clamp((best * best).sum(dim=-1, keepdim=True), min=1e-30))
    # degenerate neighbourhoods (isotropic covariance, p ~ 0): +z
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    degenerate = (norm[..., 0] < 1e-12) | (p < 1e-12)
    return torch.where(degenerate[..., None], fallback, best / norm)


def estimate_pointcloud_normals(points: torch.Tensor, k: int = 30) -> torch.Tensor:
    """(B, N, 3) -> (B, N, 3) unit normals, sign not disambiguated."""
    points = points.contiguous()
    k = min(k, points.shape[1])
    idx = knn_point(k, points, points)  # (B, N, k), self included
    nbr = index_points(points, idx)  # (B, N, k, 3)
    d = nbr - nbr.mean(dim=2, keepdim=True)
    d = d.to(torch.promote_types(points.dtype, torch.float32))
    cov = torch.einsum("bnki,bnkj->bnij", d, d) / k  # (B, N, 3, 3)
    return _smallest_eigvec_sym3x3(cov)
