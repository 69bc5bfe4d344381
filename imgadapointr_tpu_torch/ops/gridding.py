"""Point <-> voxel gridding ops of GRNet.

Counterpart of ``imgadapointr_tpu/ops/gridding.py:33-265`` (the reference's
gridding, gridding-reverse, cubic-feature-sampling and gridding-loss CUDA
extensions), differentiable in the points and the features:

- :func:`gridding`: a cloud rasterised onto a scale³ vertex grid with the
  trilinear corner weights ``1 - |x - x0|`` of each point's cell; the
  weights are scattered by :func:`~.pointops.scatter_add_rows` (kernel
  ``csrc/scatter_add_rows.cu``, C = 1), which sums each vertex's sources in
  source order, so the grid has the same bits on the card and the CPU and
  two runs agree. Its VJP is a row gather of the grid's cotangent.
- :func:`gridding_reverse`: grid -> scale³ points, each cell the centroid of
  its 8 lower corners' weights; dense torch (shifted views, an einsum).
- :func:`cubic_feature_sampling`: the features of the 8 voxel vertices
  around each point, through :func:`~.pointops.gather_rows` over the
  (B, s³, C) volume (kernel ``csrc/gather_rows.cu``), 0 outside the grid;
  its VJP is the deterministic scatter-add.
- :func:`gridding_distance` / :func:`gridding_loss`: both clouds on a
  shared grid with 8 corner slots a vertex, anchored at the bounding box of
  both clouds and the batch; the loss is the alpha-weighted L1 mean.

Cell indices carry no gradient; the reference's zero-padded rows get weight
0 (its ``non_zeros`` filter at fixed shape).
"""

from __future__ import annotations

import warnings

import torch

from .pointops import gather_rows, index_points, scatter_add_rows

EPS = 1e-4  # gridding_reverse.cu's


def _corner_data(pts: torch.Tensor):
    """(corners (B, N, 8, 3) int64 lattice coordinates, weights (B, N, 8))
    of each point's cell, in the CUDA kernels' corner order LLL, LLU, LUL,
    LUU, ULL, ULU, UUL, UUU; each weight ``(wx * wy) * wz``."""
    lo = torch.floor(pts).detach()
    up = lo + 1.0
    wl = 1.0 - (pts - lo).abs()
    wu = 1.0 - (pts - up).abs()
    sel = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], dtype=torch.bool,
                       device=pts.device)
    corners = torch.where(sel, up[:, :, None, :], lo[:, :, None, :]).long()
    w = torch.where(sel, wu[:, :, None, :], wl[:, :, None, :])
    return corners, w[..., 0] * w[..., 1] * w[..., 2]


def _nonzero_mask(ptcloud: torch.Tensor) -> torch.Tensor:
    """1 for a real row, 0 for a zero-padded one (the reference's ``non_zeros``)."""
    return (ptcloud.abs().sum(dim=-1) > 0).to(ptcloud.dtype)


class _ScatterRows(torch.autograd.Function):
    """:func:`scatter_add_rows`, differentiable in the values: the VJP is
    the gather of the output's cotangent at the same indices."""

    @staticmethod
    def forward(ctx, n_rows, idx, vals):
        ctx.save_for_backward(idx)
        return scatter_add_rows(n_rows, idx, vals)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return None, None, gather_rows(grad.contiguous(), idx)


def _raster(weights: torch.Tensor, n_rows: int, flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each point's corner weights (B, N, 8) added into rows ``flat`` of
    (B, n_rows) zeros; an invalid corner adds 0 to row 0."""
    B = weights.shape[0]
    flat = torch.where(valid, flat, 0).reshape(B, -1).contiguous()
    vals = torch.where(valid, weights, 0.0).reshape(B, -1, 1).contiguous()
    return _ScatterRows.apply(n_rows, flat, vals)[..., 0]


def gridding(ptcloud: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, N, 3) cloud in [-1, 1] -> (B, scale, scale, scale) density grid:
    the cloud times ``scale // 2`` on vertices ``[-scale // 2, scale // 2 - 1]``
    an axis; a corner outside the grid adds nothing."""
    half = scale // 2
    pts = ptcloud * half
    corners, weights = _corner_data(pts)
    weights = weights * _nonzero_mask(ptcloud)[..., None]
    idx = corners + half
    valid = ((idx >= 0) & (idx < scale)).all(dim=-1)
    flat = (idx[..., 0] * scale + idx[..., 1]) * scale + idx[..., 2]
    return _raster(weights, scale**3, flat, valid).reshape(-1, scale, scale, scale)


def gridding_reverse(grid: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, scale³) or (B, s, s, s) grid -> (B, scale³, 3) cloud: each cell
    (x, y, z) the centroid of the weights at its 8 lower corners, (0, 0, 0)
    where the weights sum below ``EPS`` or on the 0 boundary, divided by
    ``scale / 2`` (``gridding_reverse.cu:30-103`` and its wrapper)."""
    B = grid.shape[0]
    g = grid.reshape(B, scale, scale, scale)
    half = scale // 2
    gp = torch.nn.functional.pad(g, (1, 0, 1, 0, 1, 0))  # a zero plane before each axis
    xs = torch.arange(scale, device=grid.device)
    xg, yg, zg = torch.meshgrid(xs, xs, xs, indexing="ij")
    views, coords = [], []
    for dx in (1, 0):
        for dy in (1, 0):
            for dz in (1, 0):
                views.append(gp[:, 1 - dx:1 - dx + scale, 1 - dy:1 - dy + scale, 1 - dz:1 - dz + scale])
                coords.append(torch.stack([xg - half - dx, yg - half - dy, zg - half - dz], dim=-1))
    w = torch.stack(views, dim=-1)  # (B, s, s, s, 8)
    c = torch.stack(coords, dim=-2).to(grid.dtype)  # (s, s, s, 8, 3)
    wsum = w.sum(dim=-1, keepdim=True)
    ok = wsum[..., 0] >= EPS
    pts = torch.einsum("bxyzk,xyzkc->bxyzc", w / wsum.clamp_min(EPS), c)
    boundary = (xg > 0) & (yg > 0) & (zg > 0)
    pts = torch.where((ok & boundary)[..., None], pts, 0.0)
    return pts.reshape(B, scale**3, 3) / scale * 2.0


def cubic_feature_sampling(ptcloud: torch.Tensor, cubic_features: torch.Tensor,
                           neighborhood_size: int = 1) -> torch.Tensor:
    """(B, N, (2 ns)³, C): for each point of ``ptcloud`` (B, N, 3) in [-1, 1]
    the features of the (2 ns)³ vertices of ``cubic_features`` (B, s, s, s,
    C), channels last, around it; 0 for a vertex outside the grid. One row
    gather over the (B, s³, C) volume (clamped indices, then the mask)."""
    B, s, C = cubic_features.shape[0], cubic_features.shape[1], cubic_features.shape[-1]
    N, ns = ptcloud.shape[1], neighborhood_size
    lower = torch.floor(ptcloud.detach() * (s / 2.0) + s / 2.0).long()  # (B, N, 3)
    offs = torch.arange(1 - ns, 1 + ns, device=ptcloud.device)
    off = torch.stack(torch.meshgrid(offs, offs, offs, indexing="ij"), dim=-1).reshape(-1, 3)
    vtx = lower[:, :, None, :] + off  # (B, N, V, 3)
    valid = ((vtx >= 0) & (vtx < s)).all(dim=-1)
    vc = vtx.clamp(0, s - 1)
    flat = (vc[..., 0] * s + vc[..., 1]) * s + vc[..., 2]  # (B, N, V)
    gathered = index_points(cubic_features.reshape(B, s**3, C), flat)
    return torch.where(valid[..., None], gathered, 0.0)


def gridding_distance(pred_cloud: torch.Tensor, gt_cloud: torch.Tensor, scale: int, span: float = 2.0):
    """Both clouds rasterised with 8 corner slots a vertex on one grid
    anchored at the bounding box of both clouds over the whole batch (zero
    rows included: ``floor(min) - 1`` to ``ceil(max) + 1`` of the clouds
    times ``scale / 2``), held in a buffer of L = ceil(span * scale / 2) + 3
    vertices an axis (``gridding_distance.cu:180-207``). Returns (pred_grid,
    gt_grid (B, L, L, L, 8), the bounding box's element count for the mean);
    warns when the box outgrows the buffer, whose points are then dropped."""
    half = scale / 2.0
    p, g = pred_cloud * half, gt_cloud * half
    L = int(-(-span * scale // 2)) + 3
    allpts = torch.cat([p, g], dim=1).detach()
    mn = torch.floor(allpts.amin(dim=(0, 1))) - 1.0
    mx = torch.ceil(allpts.amax(dim=(0, 1))) + 1.0
    origin = mn.long()
    if float((mx - mn + 1.0).max()) > L:
        warnings.warn(f"gridding_distance: the bounding box ({float((mx - mn + 1.0).max())} vertices an "
                      f"axis) exceeds the buffer (L={L}); points beyond it are dropped: raise `span`")
    slots = torch.arange(8, device=pred_cloud.device)

    def raster(pts, raw):
        corners, weights = _corner_data(pts)
        weights = weights * _nonzero_mask(raw)[..., None]
        idx = corners - origin
        valid = ((idx >= 0) & (idx < L)).all(dim=-1)
        flat = ((idx[..., 0] * L + idx[..., 1]) * L + idx[..., 2]) * 8 + slots
        return _raster(weights, L**3 * 8, flat, valid).reshape(-1, L, L, L, 8)

    n_elems = torch.prod(mx - mn + 1.0) * 8 * pred_cloud.shape[0]
    return raster(p, pred_cloud), raster(g, gt_cloud), n_elems


def gridding_loss(pred_cloud: torch.Tensor, gt_cloud: torch.Tensor, scales, alphas,
                  span: float = 2.0) -> torch.Tensor:
    """``sum_i alpha_i * mean |pred_grid_i - gt_grid_i|`` over the scales
    (the reference's gridding loss, ``__init__.py:92-114``)."""
    total = 0.0
    for s, a in zip(scales, alphas):
        pg, gg, n = gridding_distance(pred_cloud, gt_cloud, int(s), span=span)
        total = total + a * (pg - gg).abs().sum() / n.clamp_min(1.0)
    return total
