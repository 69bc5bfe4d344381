"""Local graph attention (counterpart of ``imgadapointr_tpu/nn/local_attention.py``).

Only ``DynamicGraphAttention`` (the 'graph' block token, the flagship's),
with the two-phase neighbour search of the denoise task. The deformable
tokens ('rw_deform', 'deform', 'deform_graph') wait (ROADMAP Queue 1:
deformable attention).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import index_points, knn_point
from .layers import Linear, leaky_relu


def two_phase_knn_gather(k: int, q_pos, v_pos, feats, denoise_length: int):
    """Two-phase kNN gather of the denoise task
    (``imgadapointr_tpu/nn/local_attention.py:106-122``): the real queries
    (all but the last ``denoise_length``) search their neighbours among the
    real tokens only, the denoise queries among all tokens. Returns the
    gathered (B, N, k, C_i) tensor for each array of ``feats``."""
    L = denoise_length
    idx_r = knn_point(k, v_pos[:, :-L].contiguous(), q_pos[:, :-L].contiguous())
    idx_n = knn_point(k, v_pos, q_pos[:, -L:].contiguous())
    return [
        torch.cat([index_points(f[:, :-L], idx_r), index_points(f, idx_n)], dim=1)
        for f in feats
    ]


class DynamicGraphAttention(nn.Module):
    """Edge conv over the kNN graph: max_k LeakyReLU(cat(v_nbr - q, q) W + b).

    ``knn_map`` is applied commuted past the gather, as the JAX package does
    (``local_attention.py:336-364``): with W = [W1 | W2] split by input
    halves, ``cat(v_nbr - q, q) W + b == gather(v W1 + b) + q (W2 - W1)``,
    so the (B, N, k, 2C) edge tensor never exists and only the (B, N, C)
    product is gathered.
    """

    def __init__(self, dim: int, k: int = 10):
        super().__init__()
        self.k = k
        self.knn_map = nn.Sequential(Linear(dim * 2, dim), nn.LeakyReLU(0.2))

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None,
                denoise_length: int = 0) -> torch.Tensor:
        lin = self.knn_map[0]
        C = lin.out_features
        w = lin.weight
        if denoise_length == 0:
            v = q if v is None else v
            v_pos = q_pos if v_pos is None else v_pos
            if idx is None:
                idx = knn_point(self.k, v_pos, q_pos)
            local_u = index_points(F.linear(v, w[:, :C], lin.bias), idx)  # v W1 + b
        else:
            if v is not None or v_pos is not None or idx is not None:
                raise ValueError("DynamicGraphAttention: denoise mode is self-attention only")
            u = F.linear(q, w[:, :C], lin.bias)
            (local_u,) = two_phase_knn_gather(self.k, q_pos, q_pos, (u,), denoise_length)
        c = F.linear(q, w[:, C:] - w[:, :C])  # q (W2 - W1)
        out = leaky_relu(local_u + c[:, :, None])
        return out.amax(dim=2)
