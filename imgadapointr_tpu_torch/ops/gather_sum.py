"""Weighted gather-sum: ``out[b, s] = Σ_m w[b, s, m] · feats[b, idx[b, s, m]]``.

Counterpart of ``imgadapointr_tpu/ops/pallas/gather_sum.py`` (forward and
VJP): the neighbour aggregation of GDANet's Geometry-Disentangle Module
(``models/gdanet.py:gdm``). :func:`weighted_gather_sum` is a
``torch.autograd.Function`` whose forward and two backward products each
have a wrapper and a plain PyTorch version beside it:

- forward: :func:`weighted_gather_sum_forward` /
  :func:`weighted_gather_sum_plain` (``csrc/weighted_gather_sum.cu``);
- ``dfeats = Wᵀ g``: :func:`weighted_gather_sum_dfeats` /
  :func:`weighted_gather_sum_dfeats_plain` and
- ``dw = g · feats[idx]``: :func:`weighted_gather_sum_dweights` /
  :func:`weighted_gather_sum_dweights_plain`
  (both ``csrc/weighted_gather_sum_bwd.cu``; the Pallas ``_dfeats_kernel``
  and ``_dweights_kernel``).

A wrapper launches its kernel for a CUDA tensor, at every shape (the TPU's
size gate, ``imgadapointr_tpu/models/gdanet.py:104-111``, is a VMEM limit
of the Pallas design), and takes the plain version for a CPU tensor only;
the Function is the same code on both devices. The index gets no gradient.
No training path reaches the backward: the GDM's sum only ranks points
(its output feeds a top-k), so no cotangent arrives, in the JAX package
too (``tests/test_torch_branch_train.py``).

Out-of-range indices contribute nothing, as in the Pallas kernel, whose
compare-select gives such an index no column (``gather_sum.py:38-41``):
no term of the forward, no ``dfeats`` contribution and ``dw = 0``. The
JAX package's XLA route clamps it through ``index_points`` instead. No
caller produces one: the indices come from a top-k.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .pointops import _on_cpu

_INT32_MAX = 2**31 - 1


def _invalid(idx: torch.Tensor, M: int) -> torch.Tensor:
    return (idx < 0) | (idx >= M)


def _neighbours(idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """(B, S, K, C) rows ``feats[b, clamp(idx[b, s, m])]``."""
    B, S, K = idx.shape
    M, C = feats.shape[1], feats.shape[2]
    flat = idx.clamp(0, M - 1).reshape(B, S * K, 1).expand(B, S * K, C)
    return torch.gather(feats, 1, flat).reshape(B, S, K, C)


def weighted_gather_sum_plain(w: torch.Tensor, idx: torch.Tensor,
                              feats: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: gather the (B, S, K, C) neighbours,
    drop the terms of out-of-range indices, sum over K."""
    invalid = _invalid(idx, feats.shape[1])[..., None]
    return (w[..., None] * _neighbours(idx, feats)).masked_fill(invalid, 0.0).sum(dim=2)


def weighted_gather_sum_dfeats_plain(w: torch.Tensor, idx: torch.Tensor, g: torch.Tensor,
                                     n_rows: int, groups: int = 1) -> torch.Tensor:
    """Plain version of :func:`weighted_gather_sum_dfeats`: the (B, S, K, C)
    terms ``w · g`` (each product rounded once) added into their rows with
    ``index_add_``, an out-of-range term as zero. On the CPU each element is
    the sum of its terms in increasing flat (s, m) order, starting from zero,
    which the kernel repeats (``tests/test_torch_branch_train.py`` holds the
    plain version to that order). With ``groups`` > 1 the cotangent's channel
    groups are copied into group-major order first and the result back."""
    if groups > 1:
        Bo, S, C = g.shape
        cg = C // groups
        g = g.reshape(Bo, S, groups, cg).permute(0, 2, 1, 3).reshape(Bo * groups, S, cg)
        out = weighted_gather_sum_dfeats_plain(w, idx, g, n_rows)
        return out.reshape(Bo, groups, n_rows, cg).permute(0, 2, 1, 3).reshape(Bo, n_rows, C)
    B, S, K = w.shape
    C = g.shape[-1]
    terms = (w[..., None] * g[:, :, None, :]).masked_fill(_invalid(idx, n_rows)[..., None], 0.0)
    rows = idx.clamp(0, n_rows - 1) + torch.arange(B, device=idx.device)[:, None, None] * n_rows
    out = torch.zeros(B * n_rows, C, dtype=g.dtype, device=g.device)
    return out.index_add_(0, rows.reshape(-1), terms.reshape(-1, C)).reshape(B, n_rows, C)


def weighted_gather_sum_dweights_plain(idx: torch.Tensor, g: torch.Tensor,
                                       feats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`weighted_gather_sum_dweights`: each
    neighbour row dotted with ``g``, zero at an out-of-range index."""
    dw = (_neighbours(idx, feats) * g[:, :, None, :]).sum(dim=-1)
    return dw.masked_fill(_invalid(idx, feats.shape[1]), 0.0)


def _check(name: str, w: torch.Tensor | None, idx: torch.Tensor, n_rows: int,
           other: torch.Tensor, groups: int = 1) -> None:
    """Raise unless idx (B, S, K) int64 indexes a table of ``n_rows`` rows,
    ``w`` (when given) has its shape, and ``other`` is a (B / groups, *,
    groups C) tensor."""
    if (idx.dim() != 3 or (w is not None and w.shape != idx.shape) or other.dim() != 3
            or groups < 1 or other.shape[0] * groups != idx.shape[0] or other.shape[2] % groups):
        raise ValueError(
            f"{name}: w and idx (B, S, K) and a (B / {groups}, *, {groups} C) tensor expected, got "
            f"{None if w is None else tuple(w.shape)}, {tuple(idx.shape)} and {tuple(other.shape)}"
        )
    if n_rows == 0:
        raise ValueError(f"{name}: empty table")
    if n_rows > _INT32_MAX:
        raise ValueError(f"{name}: the kernel takes at most 2**31 - 1 rows, got {n_rows}")
    if idx.dtype != torch.int64:
        raise TypeError(f"{name}: int64 indices expected, got {idx.dtype}")


def _require_kernel_inputs(name: str, idx: torch.Tensor, *tensors: torch.Tensor) -> None:
    _build.require_cuda_f32(name, tensors[0].device, *tensors)
    if idx.device != tensors[0].device or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous on the table's device")


def weighted_gather_sum_forward(w: torch.Tensor, idx: torch.Tensor,
                                feats: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: kernel on the card, plain on the CPU."""
    _check("weighted_gather_sum", w, idx, feats.shape[1], feats)
    if _on_cpu("weighted_gather_sum", feats):
        return weighted_gather_sum_plain(w, idx, feats)
    _require_kernel_inputs("weighted_gather_sum", idx, feats, w)
    B, S, K = w.shape
    M, C = feats.shape[1], feats.shape[2]
    out = torch.empty(B, S, C, dtype=feats.dtype, device=feats.device)
    _build.launch(
        "weighted_gather_sum", "weighted_gather_sum_f32", feats.device,
        w.data_ptr(), idx.data_ptr(), feats.data_ptr(), out.data_ptr(), B, S, K, M, C,
    )
    return out


@functools.lru_cache(maxsize=None)
def _dfeats_scratch(B: int, S: int, K: int, n_rows: int, C: int) -> int:
    """The int32 scratch entries the ``dfeats`` kernel takes: none where its
    sort fits in shared memory (every 3-NN VJP), else room for its counts
    and term lists."""
    return _build.library().weighted_gather_sum_dfeats_scratch(B, S, K, n_rows, C)


def weighted_gather_sum_dfeats(w: torch.Tensor, idx: torch.Tensor, g: torch.Tensor,
                               n_rows: int, groups: int = 1) -> torch.Tensor:
    """``dfeats[b, j, :] = Σ_{s, m: idx[b, s, m] = j} w[b, s, m] · g[b, s, :]``:
    (B, n_rows, C), the gradient of the forward's table for the cotangent
    ``g`` (B, S, C). On the card one kernel sorts each batch element's terms
    by destination, stably (in shared memory where an element has at most
    16384 terms, else in int32 scratch allocated here), then adds each
    row's terms in (s, m) order: every element is the plain version's
    float32 sum in the same order, so the kernel is bit-equal to the plain
    version on the CPU and two runs give the same bits.

    With ``groups`` > 1, w and idx are (B g, S, K) and g is (B, S, g C):
    batch element b g + j is channel group j of b, reading its cotangent at
    channels [j C, (j + 1) C) of g and writing its rows there in the (B,
    n_rows, g C) result (the grouped 3-NN interpolation's VJP). The kernel
    reads and writes in place; its bits are those of the same call on the
    groups' contiguous copies."""
    _check("weighted_gather_sum_dfeats", w, idx, n_rows, g, groups)
    if _on_cpu("weighted_gather_sum_dfeats", g):
        return weighted_gather_sum_dfeats_plain(w, idx, g, n_rows, groups)
    _require_kernel_inputs("weighted_gather_sum_dfeats", idx, g, w)
    B, S, K = w.shape
    C = g.shape[2] // groups
    out = torch.empty(g.shape[0], n_rows, g.shape[2], dtype=g.dtype, device=g.device)
    n_scratch = _dfeats_scratch(B, S, K, n_rows, C)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=g.device) if n_scratch else None
    _build.launch(
        "weighted_gather_sum_dfeats", "weighted_gather_sum_dfeats_f32", g.device,
        w.data_ptr(), idx.data_ptr(), g.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, S, K, n_rows, C, groups,
    )
    return out


def weighted_gather_sum_dweights(idx: torch.Tensor, g: torch.Tensor,
                                 feats: torch.Tensor) -> torch.Tensor:
    """``dw[b, s, m] = g[b, s, :] · feats[b, idx[b, s, m], :]`` (B, S, K),
    0 at an out-of-range index: the gradient of the forward's weights for
    the cotangent ``g`` (B, S, C). The kernel's sum order is fixed."""
    _check("weighted_gather_sum_dweights", None, idx, feats.shape[1], feats)
    if g.shape != (*idx.shape[:2], feats.shape[2]):
        raise ValueError(f"weighted_gather_sum_dweights: g {tuple(g.shape)} does not fit "
                         f"idx {tuple(idx.shape)} and feats {tuple(feats.shape)}")
    if _on_cpu("weighted_gather_sum_dweights", feats):
        return weighted_gather_sum_dweights_plain(idx, g, feats)
    _require_kernel_inputs("weighted_gather_sum_dweights", idx, feats, g)
    B, S, K = idx.shape
    M, C = feats.shape[1], feats.shape[2]
    out = torch.empty(B, S, K, dtype=feats.dtype, device=feats.device)
    _build.launch(
        "weighted_gather_sum_dweights", "weighted_gather_sum_dweights_f32", feats.device,
        idx.data_ptr(), g.data_ptr(), feats.data_ptr(), out.data_ptr(), B, S, K, M, C,
    )
    return out


class _WeightedGatherSum(torch.autograd.Function):
    """The forward and its VJP (``gather_sum.py:179-185``): ``dw`` and
    ``dfeats``, none for ``idx``."""

    @staticmethod
    def forward(ctx, w, idx, feats):
        ctx.save_for_backward(w, idx, feats)
        return weighted_gather_sum_forward(w, idx, feats)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        w, idx, feats = ctx.saved_tensors
        g = g.contiguous()
        dw = weighted_gather_sum_dweights(idx, g, feats) if ctx.needs_input_grad[0] else None
        df = weighted_gather_sum_dfeats(w, idx, g, feats.shape[1]) if ctx.needs_input_grad[2] else None
        return dw, None, df


def weighted_gather_sum(w: torch.Tensor, idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """``out[b, s, :] = Σ_{m<K} w[b, s, m] · feats[b, idx[b, s, m], :]``.

    w (B, S, K), idx (B, S, K) int64, feats (B, M, C) -> (B, S, C); an index
    outside [0, M) contributes nothing. Differentiable in ``w`` and
    ``feats``: the backward is :func:`weighted_gather_sum_dweights` and
    :func:`weighted_gather_sum_dfeats`.
    """
    return _WeightedGatherSum.apply(w, idx, feats)
