"""Weighted gather-sum: ``out[b, s] = Σ_m w[b, s, m] · feats[b, idx[b, s, m]]``.

Counterpart of ``imgadapointr_tpu/ops/pallas/gather_sum.py`` (forward):
the neighbour aggregation of GDANet's Geometry-Disentangle Module
(``models/gdanet.py:gdm``). :func:`weighted_gather_sum` launches
``csrc/weighted_gather_sum.cu`` for a CUDA tensor, at every shape (the TPU's
size gate, ``imgadapointr_tpu/models/gdanet.py:104-111``, is a VMEM limit
of the Pallas design); :func:`weighted_gather_sum_plain` is the same
function in plain PyTorch, which the wrapper takes for a CPU tensor only.

Out-of-range indices contribute nothing, as in the Pallas kernel, whose
compare-select gives such an index no column (``gather_sum.py:38-41``);
the JAX package's XLA route clamps it through ``index_points`` instead. No
caller produces one: the indices come from a top-k.

Forward only: the kernel's backward (the Pallas ``_dfeats_kernel`` and
``_dweights_kernel``) comes with the training slice of the models that use
it, and a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import torch

from . import _build
from .pointops import _on_cpu

_INT32_MAX = 2**31 - 1


def weighted_gather_sum_plain(w: torch.Tensor, idx: torch.Tensor,
                              feats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`weighted_gather_sum`: gather the (B, S, K, C)
    neighbours, drop the terms of out-of-range indices, sum over K."""
    B, S, K = w.shape
    M, C = feats.shape[1], feats.shape[2]
    invalid = ((idx < 0) | (idx >= M))[..., None]
    flat = idx.clamp(0, M - 1).reshape(B, S * K, 1).expand(B, S * K, C)
    nbr = torch.gather(feats, 1, flat).reshape(B, S, K, C)
    return (w[..., None] * nbr).masked_fill(invalid, 0.0).sum(dim=2)


def weighted_gather_sum(w: torch.Tensor, idx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """``out[b, s, :] = Σ_{m<K} w[b, s, m] · feats[b, idx[b, s, m], :]``.

    w (B, S, K), idx (B, S, K) int64, feats (B, M, C) -> (B, S, C); an index
    outside [0, M) contributes nothing. On the CPU the plain version, which
    autograd differentiates; on the card the kernel, forward only.
    """
    if w.dim() != 3 or feats.dim() != 3 or idx.shape != w.shape or feats.shape[0] != w.shape[0]:
        raise ValueError(
            f"weighted_gather_sum: w (B, S, K), idx (B, S, K) and feats (B, M, C) "
            f"expected, got {tuple(w.shape)}, {tuple(idx.shape)} and {tuple(feats.shape)}"
        )
    if feats.shape[1] == 0:
        raise ValueError("weighted_gather_sum: empty table")
    if idx.dtype != torch.int64:
        raise TypeError(f"weighted_gather_sum: int64 indices expected, got {idx.dtype}")
    if _on_cpu("weighted_gather_sum", feats):
        return weighted_gather_sum_plain(w, idx, feats)
    if w.requires_grad or feats.requires_grad:
        raise NotImplementedError(
            "weighted_gather_sum: the kernel's backward comes with the superset's "
            "training slice (ROADMAP Queue 1: the superset training slice); call it "
            "without gradients"
        )
    _build.require_cuda_f32("weighted_gather_sum", feats.device, w, feats)
    if idx.device != feats.device or not idx.is_contiguous():
        raise ValueError("weighted_gather_sum: idx must be contiguous on the table's device")
    B, S, K = w.shape
    M, C = feats.shape[1], feats.shape[2]
    if M > _INT32_MAX:
        raise ValueError(f"weighted_gather_sum: the kernel takes at most 2**31 - 1 rows, got {M}")
    out = torch.empty(B, S, C, dtype=feats.dtype, device=feats.device)
    _build.launch(
        "weighted_gather_sum", "weighted_gather_sum_f32", feats.device,
        w.data_ptr(), idx.data_ptr(), feats.data_ptr(), out.data_ptr(), B, S, K, M, C,
    )
    return out
