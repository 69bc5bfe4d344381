"""Point-cloud geometry ops: row gather, kNN, farthest point sampling,
inverse-distance 3-NN interpolation.

Counterparts of ``imgadapointr_tpu/ops/pointops.py`` in batch-last (B, N, C)
layout. Each of the five kernels has a wrapper and a plain PyTorch
version of the same function beside it:

- :func:`gather_rows` / :func:`gather_rows_plain` (``csrc/gather_rows.cu``)
- :func:`scatter_add_rows` / :func:`scatter_add_rows_plain`
  (``csrc/scatter_add_rows.cu``), the gather's backward
- :func:`knn_with_distance` / :func:`knn_plain` (``csrc/knn.cu``)
- :func:`furthest_point_sample` / :func:`fps_plain` (``csrc/fps.cu``)
- :func:`three_nn_interpolate` / :func:`three_nn_interpolate_plain` and
  :func:`three_nn_interpolate_grouped` /
  :func:`three_nn_interpolate_grouped_plain` (one kernel,
  ``csrc/three_nn_interpolate.cu``), whose backward is the weighted
  gather-sum's ``dfeats`` kernel

A wrapper launches its kernel for a CUDA tensor and raises on a dtype,
shape or contiguity the kernel does not take; it takes the plain version
only for a tensor on the CPU (the parity tests, float32 or float64). There
is no fallback from the kernel to the plain version.

Selection contract (``imgadapointr_tpu/ops/pallas/nn_distance.py:17-24``):
kNN and FPS rank by the diff-form squared distance ``(dx*dx + dy*dy) +
dz*dz`` and break ties on the first index; never by the matmul form or
``torch.cdist``. Indices are int64. The one exception is
:func:`ball_query`, which ranks by :func:`square_distance`, the matmul
form, because the JAX package's ``ball_query`` does
(``imgadapointr_tpu/ops/pointops.py:22-51,377-402``); no kernel backs
either.
"""

from __future__ import annotations

import contextlib
import functools

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


def _gather_rows_forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(
            f"gather_rows: table (B, M, C) and idx (B, S) expected, got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}"
        )
    B, M, C = table.shape
    if M == 0:
        raise ValueError("gather_rows: empty table")
    if idx.dtype != torch.int64:
        raise TypeError(f"gather_rows: int64 indices expected, got {idx.dtype}")
    if _on_cpu("gather_rows", table):
        return gather_rows_plain(table, idx)
    dev = table.device
    _build.require_cuda_f32("gather_rows", dev, table)
    if idx.device != dev or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be contiguous on the table's device")
    S = idx.shape[1]
    out = table.new_empty((B, S, C))
    _build.launch(
        "gather_rows", "gather_rows_f32", dev,
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, M, S, C,
    )
    return out


class _GatherRows(torch.autograd.Function):
    """Row gather whose backward is the scatter-add kernel: the cotangent
    of ``out[b, s]`` is added to row ``clamp(idx[b, s])`` of the table's
    gradient (``imgadapointr_tpu/ops/pallas/gather_rows.py:210-221``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[1]
        return _gather_rows_forward(table, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(ctx.rows, idx, grad.contiguous()), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, s, :] = table[b, clamp(idx[b, s], 0, M - 1), :]``.

    table (B, M, C), idx (B, S) int64 -> (B, S, C). Out-of-range indices are
    clamped, as XLA's gather and the TPU kernel do (CLAUDE.md:97-99), where
    ``torch.gather`` would raise. Differentiable in ``table``: the backward
    is :func:`scatter_add_rows`. Where no gradient can flow (grad mode off,
    or a table that needs none) the forward is called directly, without
    the autograd Function's cost on the host; both routes launch the same
    kernel once.
    """
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx)
    return _gather_rows_forward(table, idx)


# ---------------------------------------------------------- row scatter-add


def scatter_add_rows_plain(n_rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows`: clamp, then
    ``Tensor.scatter_add_`` into zeros. On the CPU this sums each output
    element's contributions in increasing source order, which the kernel
    repeats (``tests/test_torch_scatter_mxu.py`` holds both to that order)."""
    B, S, C = vals.shape
    out = torch.zeros(B, n_rows, C, dtype=vals.dtype, device=vals.device)
    idx = idx.clamp(0, n_rows - 1)
    return out.scatter_add_(1, idx.unsqueeze(-1).expand(B, S, C), vals)


@functools.lru_cache(maxsize=None)
def _scatter_scratch(B: int, S: int, n_rows: int) -> int:
    """The int32 scratch entries the scatter-add kernel takes for (B, S,
    rows): none where its sort fits in shared memory (every train step's
    call), else room for its counts and source lists."""
    return _build.library().scatter_add_rows_scratch(B, S, n_rows)


def scatter_add_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[b, clamp(idx[b, s], 0, n_rows - 1), :] += vals[b, s, :]`` into
    zeros; idx (B, S) int64, vals (B, S, C) -> (B, n_rows, C).

    The two cross terms of the chamfer backward and the backward of
    :func:`gather_rows`. On the card one kernel sorts each batch element's
    sources by destination, stably (in shared memory on every train step's
    call, else in int32 scratch allocated here), then adds each row's
    sources in source order: every element is the plain version's float32
    sum in the same order, so the kernel is bit-equal to the plain version
    on the CPU and two runs give the same bits.
    """
    if vals.dim() != 3 or idx.dim() != 2 or idx.shape != vals.shape[:2]:
        raise ValueError(
            f"scatter_add_rows: idx (B, S) and vals (B, S, C) expected, got "
            f"{tuple(idx.shape)} and {tuple(vals.shape)}"
        )
    if n_rows < 1:
        raise ValueError(f"scatter_add_rows: needs n_rows >= 1, got {n_rows}")
    if idx.dtype != torch.int64:
        raise TypeError(f"scatter_add_rows: int64 indices expected, got {idx.dtype}")
    if _on_cpu("scatter_add_rows", vals):
        return scatter_add_rows_plain(n_rows, idx, vals)
    _build.require_cuda_f32("scatter_add_rows", vals.device, vals)
    if idx.device != vals.device or not idx.is_contiguous():
        raise ValueError("scatter_add_rows: idx must be contiguous on the values' device")
    B, S, C = vals.shape
    out = torch.empty(B, n_rows, C, dtype=vals.dtype, device=vals.device)
    n_scratch = _scatter_scratch(B, S, n_rows)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=vals.device) if n_scratch else None
    _build.launch(
        "scatter_add_rows", "scatter_add_rows_f32", vals.device,
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), scratch.data_ptr() if n_scratch else None,
        B, S, n_rows, C,
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


# ------------------------------------------------ matmul-form distance, ball query


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the block's CUDA matmuls, then back as it was."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., N, M) squared distances of ``src`` (..., N, C) to ``dst`` (...,
    M, C) in the matmul form ``(-2 src·dstᵀ + |src|²) + |dst|²``, accumulated
    in >= float32 with TF32 off (reference Transformer_utils.py:32-51,
    ``imgadapointr_tpu/ops/pointops.py:22-51``). Not a selection metric of
    the port: kNN and FPS rank by the diff form."""
    acc = torch.promote_types(src.dtype, torch.float32)
    src, dst = src.to(acc), dst.to(acc)
    with _full_f32_matmul():
        d = -2.0 * torch.matmul(src, dst.transpose(-2, -1))
    d = d + (src * src).sum(dim=-1, keepdim=True)
    return d + (dst * dst).sum(dim=-1)[..., None, :]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) int64: for each query of ``new_xyz`` (B, S, 3) the
    first ``nsample`` points of ``xyz`` (B, N, 3) within ``radius``, in
    *index* order (pointnet2 ``ball_query``); a short neighbourhood repeats
    its first in-radius point, a query with none gets index 0. Points are
    in the ball where :func:`square_distance` (the matmul form, as the JAX
    package's ``ball_query`` ranks) is <= radius². Non-differentiable."""
    N = xyz.shape[1]
    in_ball = square_distance(new_xyz.detach(), xyz.detach()) <= radius * radius
    ar = torch.arange(N, device=xyz.device)
    key = torch.where(in_ball, ar, torch.full_like(ar, N))  # (B, S, N)
    idx = torch.topk(key, min(nsample, N), dim=-1, largest=False, sorted=True).values
    if nsample > N:  # more slots than points: the extra slots repeat the filler
        idx = torch.cat([idx, idx.new_full((*idx.shape[:-1], nsample - N), N)], dim=-1)
    valid = idx < N
    first = torch.where(valid[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
    return torch.where(valid, idx, first)


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
    chunks = knn_chunks(B, S, M, xyz.device)
    # each (query, chunk)'s k-list as (distance bits, index), merged in chunk order
    part = torch.empty(B, S, chunks, nsample, 2, dtype=torch.int32, device=xyz.device) if chunks > 1 else None
    _build.launch(
        "knn", "knn_f32", xyz.device,
        xyz.data_ptr(), new_xyz.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        None if part is None else part.data_ptr(), B, M, S, nsample, chunks,
    )
    return dist, idx


@functools.lru_cache(maxsize=None)
def knn_chunks(B: int, S: int, M: int, device: torch.device) -> int:
    """The kernel's reference chunks for B x S queries against M points,
    as its source picks them (``csrc/knn.cu:knn_chunks``): more than one
    only where the queries leave the card under-filled."""
    return _build.library().knn_chunks(B, S, M, _build.sm_count(device))


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
        raise ValueError(f"fps: the kernel holds at most {max_n} points in one block's registers, got {N}")
    B = xyz.shape[0]
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    _build.launch(
        "fps", "fps_f32", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N, npoint
    )
    return out


def fps(data: torch.Tensor, number: int) -> torch.Tensor:
    """FPS returning the sampled coordinates (B, number, 3)."""
    return index_points(data, furthest_point_sample(data, number))


# ------------------------------------------------ inverse-distance 3-NN interpolation


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(dist (B, N, 3), idx (B, N, 3) int64): the 3 nearest ``known`` (B, M, 3)
    points of each ``unknown`` (B, N, 3) query and their *euclidean* (not
    squared) distances, ascending, first index on ties (pointnet2
    ``three_nn``; ``imgadapointr_tpu/ops/pointops.py:194-207``)."""
    sq, idx = knn_with_distance(3, known, unknown)
    return torch.sqrt(sq.clamp_min(0.0)), idx


def three_weights(sq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) squared distances -> inverse-distance weights
    ``r_i / ((r_0 + r_1) + r_2)`` with ``r_i = 1 / (sqrt(d_i) + eps)``, in the
    fused kernel's order of operations."""
    r = torch.reciprocal(torch.sqrt(sq.clamp_min(0.0)) + eps)
    return r / ((r[..., 0] + r[..., 1]) + r[..., 2])[..., None]


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``out[b, n] = ((w_0 f[idx_0] + w_1 f[idx_1]) + w_2 f[idx_2])``: feats
    (B, M, C), idx and weight (B, N, 3) -> (B, N, C), summed in the fused
    kernel's order (no matrix product, whose order would be the library's)."""
    rows = [gather_rows_plain(feats, idx[..., j]) for j in range(3)]
    return (weight[..., 0, None] * rows[0] + weight[..., 1, None] * rows[1]) \
        + weight[..., 2, None] * rows[2]


def three_nn_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor, feats: torch.Tensor,
                               eps: float = 1e-8):
    """Plain version of the fused kernel: (out (B, N, C), idx (B, N, 3),
    weight (B, N, 3)) from :func:`knn_plain`, :func:`three_weights` and
    :func:`three_interpolate`."""
    sq, idx = knn_plain(3, known, unknown)
    w = three_weights(sq, eps)
    return three_interpolate(feats, idx, w), idx, w


def three_nn_interpolate_grouped_plain(pos: torch.Tensor, offset: torch.Tensor, known: torch.Tensor,
                                       v: torch.Tensor, eps: float = 1e-8):
    """Plain version of the grouped kernel: the deformable gather's
    composition (``imgadapointr_tpu/nn/local_attention.py:80-88``): the
    queries ``pos + offset`` (B g, S, 3), one copy of ``known`` a group, ``v``
    in group-major order (B g, M, cg), :func:`three_nn_interpolate_plain`,
    and the result permuted back. Returns (out (B, S, C), idx (B, g, S, 3),
    weight (B, g, S, 3))."""
    B, S, _ = pos.shape
    g, (M, C) = offset.shape[1], v.shape[1:]
    cg = C // g
    shift = (pos[:, None] + offset).reshape(B * g, S, 3)
    known_g = known[:, None].expand(B, g, M, 3).reshape(B * g, M, 3)
    v_g = v.reshape(B, M, g, cg).permute(0, 2, 1, 3).reshape(B * g, M, cg)
    out, idx, w = three_nn_interpolate_plain(shift, known_g, v_g, eps)
    out = out.reshape(B, g, S, cg).permute(0, 2, 1, 3).reshape(B, S, C)
    return out, idx.reshape(B, g, S, 3), w.reshape(B, g, S, 3)


def _three_nn_interpolate_launch(pos: torch.Tensor, offset: torch.Tensor | None, known: torch.Tensor,
                                 feats: torch.Tensor, eps: float):
    """The kernel on CUDA tensors: (out (B, S, C), idx and w (B, G, S, 3),
    with G = 1 and no add where ``offset`` is None)."""
    name = "three_nn_interpolate"
    dev = feats.device
    _build.require_cuda_f32(name, dev, pos, known, feats)
    if offset is not None:
        _build.require_cuda_f32(name, dev, offset, ndim=4)
    B, S, _ = pos.shape
    M, C = feats.shape[1], feats.shape[2]
    G = 1 if offset is None else offset.shape[1]
    out = torch.empty(B, S, C, dtype=torch.float32, device=dev)
    idx = torch.empty(B, G, S, 3, dtype=torch.int64, device=dev)
    w = torch.empty(B, G, S, 3, dtype=torch.float32, device=dev)
    _build.launch(
        name, "three_nn_interpolate_f32", dev,
        pos.data_ptr(), None if offset is None else offset.data_ptr(), known.data_ptr(),
        feats.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(), B, S, M, C, G, eps,
    )
    return out, idx, w


def _check_known(name: str, known: torch.Tensor) -> None:
    if known.shape[1] < 3:
        raise ValueError(f"{name}: needs at least 3 known points, got {known.shape[1]}")


def _three_nn_interpolate_forward(unknown: torch.Tensor, known: torch.Tensor,
                                  feats: torch.Tensor, eps: float):
    """The fused forward without autograd: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if (unknown.dim() != 3 or known.dim() != 3 or feats.dim() != 3
            or not unknown.shape[0] == known.shape[0] == feats.shape[0]
            or feats.shape[1] != known.shape[1] or unknown.shape[-1] != 3 or known.shape[-1] != 3):
        raise ValueError(
            f"three_nn_interpolate: unknown (B, N, 3), known (B, M, 3) and feats (B, M, C) "
            f"expected, got {tuple(unknown.shape)}, {tuple(known.shape)} and {tuple(feats.shape)}"
        )
    _check_known("three_nn_interpolate", known)
    if _on_cpu("three_nn_interpolate", feats):
        return three_nn_interpolate_plain(unknown, known, feats, eps)
    out, idx, w = _three_nn_interpolate_launch(unknown, None, known, feats, eps)
    return out, idx[:, 0], w[:, 0]


def _three_nn_interpolate_grouped_forward(pos: torch.Tensor, offset: torch.Tensor,
                                          known: torch.Tensor, v: torch.Tensor, eps: float):
    """The grouped forward without autograd: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if (pos.dim() != 3 or offset.dim() != 4 or known.dim() != 3 or v.dim() != 3
            or not pos.shape[0] == offset.shape[0] == known.shape[0] == v.shape[0]
            or offset.shape[2:] != pos.shape[1:] or pos.shape[-1] != 3 or known.shape[-1] != 3
            or v.shape[1] != known.shape[1] or offset.shape[1] < 1 or v.shape[2] % offset.shape[1]):
        raise ValueError(
            f"three_nn_interpolate_grouped: pos (B, S, 3), offset (B, g, S, 3), known (B, M, 3) "
            f"and v (B, M, C) with C % g == 0 expected, got {tuple(pos.shape)}, "
            f"{tuple(offset.shape)}, {tuple(known.shape)} and {tuple(v.shape)}"
        )
    _check_known("three_nn_interpolate_grouped", known)
    if _on_cpu("three_nn_interpolate_grouped", v):
        return three_nn_interpolate_grouped_plain(pos, offset, known, v, eps)
    return _three_nn_interpolate_launch(pos, offset, known, v, eps)


class _ThreeNNInterpolate(torch.autograd.Function):
    """The fused forward and its VJP (``imgadapointr_tpu/ops/pointops.py:
    285-303``): ``dfeats[b, idx] += w * g`` is the weighted gather-sum's
    ``dfeats`` at K = 3; the positions get no gradient (pointnet2's
    ``three_nn`` has none)."""

    @staticmethod
    def forward(ctx, unknown, known, feats, eps):
        out, idx, w = _three_nn_interpolate_forward(unknown, known, feats, eps)
        ctx.save_for_backward(idx, w)
        ctx.rows = feats.shape[1]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from .gather_sum import weighted_gather_sum_dfeats

        idx, w = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[2]:
            dfeats = weighted_gather_sum_dfeats(w, idx, g.contiguous(), ctx.rows)
        return None, None, dfeats, None


def three_nn_interpolate(unknown: torch.Tensor, known: torch.Tensor, feats: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance 3-NN interpolation of ``feats`` (B, M, C) at the
    ``known`` (B, M, 3) points onto the ``unknown`` (B, N, 3) queries:
    ``w_i = (1/(d_i+eps)) / Σ_j 1/(d_j+eps)`` with euclidean ``d``, the 3
    nearest by diff-form distance, first index on ties (the reference's
    ``three_nn`` + ``three_interpolate`` chain). One kernel,
    ``csrc/three_nn_interpolate.cu`` (the one-group case of
    :func:`three_nn_interpolate_grouped`'s), on a CUDA tensor at every shape
    (the TPU's size gate, ``imgadapointr_tpu/ops/pointops.py:254-263``, is a
    VMEM limit); the plain version on a CPU tensor. Differentiable in
    ``feats`` only: the positions are detached, as the JAX package stops
    them."""
    return _ThreeNNInterpolate.apply(unknown.detach().contiguous(), known.detach().contiguous(),
                                     feats.contiguous(), float(eps))


class _ThreeNNInterpolateGrouped(torch.autograd.Function):
    """The grouped forward and its VJP: group j's ``dv[b, idx, j cg : (j +
    1) cg] += w * g[b, s, j cg : (j + 1) cg]``, the ``dfeats`` kernel reading
    the (B, S, C) cotangent and writing the (B, M, C) gradient in place, one
    batch element a group. The positions and offsets get no gradient."""

    @staticmethod
    def forward(ctx, pos, offset, known, v, eps):
        out, idx, w = _three_nn_interpolate_grouped_forward(pos, offset, known, v, eps)
        ctx.save_for_backward(idx, w)
        ctx.rows = v.shape[1]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from .gather_sum import weighted_gather_sum_dfeats

        idx, w = ctx.saved_tensors
        dv = None
        if ctx.needs_input_grad[3]:
            B, G, S, _ = idx.shape
            dv = weighted_gather_sum_dfeats(w.reshape(B * G, S, 3), idx.reshape(B * G, S, 3),
                                            g.contiguous(), ctx.rows, groups=G)
        return None, None, None, dv, None


def three_nn_interpolate_grouped(pos: torch.Tensor, offset: torch.Tensor, known: torch.Tensor,
                                 v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The deformable gather's interpolation, one call for every channel
    group: for group j < g the queries ``pos + offset[:, j]`` (pos (B, S, 3),
    offset (B, g, S, 3)) interpolate channels ``[j cg, (j + 1) cg)`` of ``v``
    (B, M, C), ``cg = C / g``, at the ``known`` (B, M, 3) points, as
    :func:`three_nn_interpolate` does. Returns (B, S, C), group j's result
    in its own channel slice: the result of
    :func:`three_nn_interpolate_grouped_plain`, which makes the layout copies
    that the kernel (``csrc/three_nn_interpolate.cu``) folds into its reads
    and writes. Differentiable in ``v`` only; the backward is the
    ``dfeats`` kernel on the cotangent in place."""
    return _ThreeNNInterpolateGrouped.apply(pos.detach().contiguous(), offset.detach().contiguous(),
                                            known.detach().contiguous(), v.contiguous(), float(eps))
