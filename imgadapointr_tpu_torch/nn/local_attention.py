"""Local graph attention (counterpart of ``imgadapointr_tpu/nn/local_attention.py``).

Only ``DynamicGraphAttention`` (the 'graph' block token, the flagship's)
on its eval branch (``denoise_length == 0``). The deformable tokens
('rw_deform', 'deform', 'deform_graph') wait (ROADMAP Queue 1: deformable attention).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import index_points, knn_point
from .layers import Linear, leaky_relu


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

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None) -> torch.Tensor:
        v = q if v is None else v
        v_pos = q_pos if v_pos is None else v_pos
        if idx is None:
            idx = knn_point(self.k, v_pos, q_pos)
        lin = self.knn_map[0]
        C = lin.out_features
        w = lin.weight
        u = F.linear(v, w[:, :C], lin.bias)  # v W1 + b
        c = F.linear(q, w[:, C:] - w[:, :C])  # q (W2 - W1)
        out = leaky_relu(index_points(u, idx) + c[:, :, None])
        return out.amax(dim=2)
