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
:func:`nn_distance_eval`, the eval metrics' entry, may instead select by
the opt-in matmul-form kernel :func:`nn_argmin_bidir_mxu`
(``csrc/nn_bidir_mxu.cu``; ``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER``).
Each kernel has its plain PyTorch version beside its wrapper.
Inside :class:`points_axis_sharding` (``--sp``) the losses run on the point
axis of a process group (``ops/sharded.py``).
"""

from __future__ import annotations

import torch

from ..utils.envflags import env_flag
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
    # the kernel merges packed (distance, index) minima of both directions
    # here and unpacks them in place into i1, then i2
    out = torch.empty(B * (N + M), dtype=torch.int64, device=x.device)
    _build.launch(
        "nn_bidir_argmin", "nn_bidir_argmin_f32", x.device,
        x.data_ptr(), y.data_ptr(), out.data_ptr(), B, N, M,
    )
    return out[: B * N].view(B, N), out[B * N :].view(B, M)


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


def _mxu_split(p: torch.Tensor):
    """(hi, lo, squared norm) of float32 points (B, N, 3): ``hi = bf16(p)``,
    ``lo = bf16(p - hi)`` (round to nearest even, back in float32) and
    ``(p0*p0 + p1*p1) + p2*p2``."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi, lo, sqdist(p)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, T, 3) -> (B, N, T): ``(a0 b0 + a1 b1) + a2 b2``."""
    t = [a[:, :, None, c] * b[:, None, :, c] for c in range(3)]
    return (t[0] + t[1]) + t[2]


def nn_argmin_bidir_mxu_plain(x: torch.Tensor, y: torch.Tensor):
    """Plain version of :func:`nn_argmin_bidir_mxu`: the matmul-form
    distance ``(|x|² − 2·cross) + |y|²`` with its cross term's three dot
    products summed in this order in float32, over column tiles of y; first
    index of the minimum in both directions. The kernel sums the same exact
    bf16 products, and the norms in exact bf16 parts, on the tensor cores in
    their own order, so it is held to this version by the JAX package's
    band, and to its indices exactly where every sum is exact (lattice
    clouds)."""
    x, y = x.float(), y.float()
    B, N, _ = x.shape
    M = y.shape[1]
    xh, xl, xs = _mxu_split(x)
    yh, yl, ys = _mxu_split(y)
    tile = max(1, min(M, _PLAIN_BLOCK // max(1, B * N)))
    best_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=x.device)
    i1 = torch.zeros(B, N, dtype=torch.int64, device=x.device)
    i2 = torch.empty(B, M, dtype=torch.int64, device=x.device)
    for base in range(0, M, tile):
        cols = slice(base, base + tile)
        yh_t, yl_t = yh[:, cols], yl[:, cols]
        cross = (_dot3(xh, yh_t) + _dot3(xh, yl_t)) + _dot3(xl, yh_t)
        d = (xs[:, :, None] - 2.0 * cross) + ys[:, None, cols]
        i2[:, cols] = d.argmin(dim=1)  # every row is in this block
        amin = d.argmin(dim=-1)
        dmin = d.gather(-1, amin[..., None])[..., 0]
        upd = dmin < best_d  # strict: an earlier tile keeps its tie
        best_d = torch.where(upd, dmin, best_d)
        i1 = torch.where(upd, amin + base, i1)
    return i1, i2


def nn_argmin_bidir_mxu(x: torch.Tensor, y: torch.Tensor):
    """(i1 (B, N), i2 (B, M)) int64 by the matmul-form distance
    ``(|x|² − 2·x·y) + |y|²`` with the cross term from bf16 hi/lo parts
    (``imgadapointr_tpu/ops/pallas/nn_distance.py:217-340``), first index
    on ties: EVAL METRICS ONLY. Its selection carries a band of about 2e-5
    relative, so the caller recomputes the distances exactly from the
    indices (:func:`nn_distance_eval`); never for a training loss. Kernel
    ``csrc/nn_bidir_mxu.cu`` on a CUDA tensor (the whole distance on the
    tensor cores, held to the plain version by the JAX package's band:
    99.9 % of the indices equal, and equal indices on lattice clouds), the
    plain version on a CPU tensor."""
    _check_clouds("nn_argmin_bidir_mxu", x, y)
    if _on_cpu("nn_argmin_bidir_mxu", x):
        return nn_argmin_bidir_mxu_plain(x, y)
    _build.require_cuda_f32("nn_argmin_bidir_mxu", x.device, x, y, last_dim=3)
    B, N, _ = x.shape
    M = y.shape[1]
    i1 = torch.empty(B, N, dtype=torch.int64, device=x.device)
    i2 = torch.empty(B, M, dtype=torch.int64, device=x.device)
    _build.launch(
        "nn_bidir_mxu", "nn_bidir_mxu_f32", x.device,
        x.data_ptr(), y.data_ptr(), i1.data_ptr(), i2.data_ptr(), B, N, M,
    )
    return i1, i2


def mxu_eval_chamfer_active(n: int, m: int, device) -> bool:
    """True iff :func:`nn_distance_eval` selects by the matmul-form kernel
    for (N, M)-point clouds on ``device``: the JAX gate
    (``imgadapointr_tpu/ops/chamfer.py:391-406``) with "on a CUDA device"
    for "on the TPU": ``IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER`` set, N·M ≥
    2**22 and N, M ≤ 2**18. Read at every call. On the H100 the flag
    pays: the kernel runs the matmul form on the tensor cores, 0.71 against
    the exact kernel's 1.27 ms at 8 x 16384² by graph replay
    (``chip_smoke.py``, NVIDIA H100 80GB HBM3, 700 W), and the exact
    distances are recomputed from its indices; its selection still carries
    the form's band (about 1 % of the nearest neighbours of a dense
    16384-point sphere differ from the exact kernel's, moving CD-L1 x1000 by
    about 1e-3), so the default stays the exact path."""
    return bool(
        torch.device(device).type == "cuda"
        and n * m >= 1 << 22
        and n <= _BIDIR_MAX_POINTS
        and m <= _BIDIR_MAX_POINTS
        and env_flag("IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER")
    )


def nn_distance_eval(x: torch.Tensor, y: torch.Tensor):
    """(d1, d2, i1, i2) of :func:`nn_distance` for EVAL METRICS ONLY;
    non-differentiable by design (the inputs are detached, as the JAX
    version stops gradients). By default this is the exact path. Under
    :func:`mxu_eval_chamfer_active` the matmul-form kernel selects the
    indices and the distances are recomputed exactly from them
    (``imgadapointr_tpu/ops/chamfer.py:439-449``)."""
    x, y = x.detach().contiguous(), y.detach().contiguous()
    if not mxu_eval_chamfer_active(x.shape[1], y.shape[1], x.device):
        return nn_distance(x, y)
    i1, i2 = nn_argmin_bidir_mxu(x, y)
    d1 = sqdist(x - index_points(y, i1)).clamp_min(0.0)
    d2 = sqdist(y - index_points(x, i2)).clamp_min(0.0)
    return d1, d2, i1, i2


def _masked_mean(v: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    if w is None:
        return v.mean()
    w = w.to(v.dtype)
    return (v * w).sum() / w.sum().clamp_min(1.0)


def _sqrt_floor(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d.clamp_min(1e-24))


# --sp: the points group of the enclosing points_axis_sharding, or None
_POINTS_GROUP = None


class points_axis_sharding:
    """Context manager: :func:`chamfer_l1` and :func:`chamfer_l2` calls
    inside it run on the point axis: each rank of ``group`` takes the
    nearest neighbours of its slice of the point dimension of both clouds
    against the other whole cloud, which every rank of the group holds, and
    the means are all-reduced (``ops/sharded.py:_global_mean``), with no
    all-gather of the clouds. A call with a mask, or whose point counts do
    not divide the group, takes the unsharded op (JAX
    ``ops/chamfer.py:38-83``, ``_points_ctx_for``). The runner enters it
    around the model's losses under ``--sp``; the losses' gradients are
    then each rank's share (the adjoint of their all-reduce), which the
    runner's gradient reduction expects (``parallel/mesh.py``)."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        global _POINTS_GROUP
        self._prev, _POINTS_GROUP = _POINTS_GROUP, self.group
        return self

    def __exit__(self, *exc):
        global _POINTS_GROUP
        _POINTS_GROUP = self._prev
        return False


def _points_group_for(x, y, w1, w2):
    """The active points group iff this (x, y) call can be sharded."""
    group = _POINTS_GROUP
    if group is None or w1 is not None or w2 is not None:
        return None
    p = group.size
    if p <= 1 or x.shape[1] % p or y.shape[1] % p:
        return None
    return group


def _points_axis_nn(x: torch.Tensor, y: torch.Tensor, group):
    """(d1, d2) of this rank's slice of the point dimension of each cloud
    against the whole other cloud, which every rank of ``group`` holds: the
    one-direction argmin (no mask) on the rank's rows, the distances
    recomputed from the winners. No collective: the gradient reaches both
    clouds through the rank's own rows and winners, its share of the whole."""
    p, r = group.size, group.rank
    xl, yl = x.chunk(p, dim=1)[r], y.chunk(p, dim=1)[r]
    with torch.no_grad():
        i1 = nn_one_direction(xl.detach().contiguous(), y.detach().contiguous())
        i2 = nn_one_direction(yl.detach().contiguous(), x.detach().contiguous())
    return sqdist(xl - index_points(y, i1)).clamp_min(0.0), sqdist(yl - index_points(x, i2)).clamp_min(0.0)


def chamfer_l1(x, y, w1=None, w2=None) -> torch.Tensor:
    """CD-L1: ``(mean(sqrt(d1)) + mean(sqrt(d2))) / 2``; with masks each
    mean divides by the number of valid points."""
    group = _points_group_for(x, y, w1, w2)
    if group is not None:
        from .sharded import _global_mean

        d1, d2 = _points_axis_nn(x, y, group)
        return (_global_mean(_sqrt_floor(d1), group, True) + _global_mean(_sqrt_floor(d2), group, True)) / 2.0
    d1, d2, _, _ = nn_distance(x, y, w1, w2)
    return (_masked_mean(_sqrt_floor(d1), w1) + _masked_mean(_sqrt_floor(d2), w2)) / 2.0


def chamfer_l2(x, y, w1=None, w2=None) -> torch.Tensor:
    """CD-L2: ``mean(d1) + mean(d2)``."""
    group = _points_group_for(x, y, w1, w2)
    if group is not None:
        from .sharded import _global_mean

        d1, d2 = _points_axis_nn(x, y, group)
        return _global_mean(d1, group, True) + _global_mean(d2, group, True)
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
