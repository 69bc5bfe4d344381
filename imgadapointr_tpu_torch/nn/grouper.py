"""DGCNN grouper (counterpart of ``imgadapointr_tpu/nn/grouper.py:22-89``).

Four edge convolutions (1x1 conv, GroupNorm(4, eps 1e-5), LeakyReLU(0.2),
max over k = 16 neighbours) and two FPS downsamples. Input (B, N, 3);
output (coor (B, num[-1], 3), feat (B, num[-1], 128)). In train mode layer
1 gathers the raw coordinates and applies ``input_trans`` after the gather
(``grouper.py:59-74``): equal in value to the eval form, and the gathered
table needs no gradient, so no (B, N, k, 8) -> (B, N, 8) scatter-add runs
in the backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import furthest_point_sample, index_points, knn_point
from .layers import GroupNorm, Linear


def _edge_layer(in_ch: int, out_ch: int) -> nn.Sequential:
    # reference Sequential(Conv2d(in, out, 1, bias=False), GroupNorm(4, out), LeakyReLU(0.2))
    return nn.Sequential(
        Linear(in_ch, out_ch, bias=False, kernel_dims=2),
        GroupNorm(4, out_ch),
        nn.LeakyReLU(0.2),
    )


class DGCNNGrouper(nn.Module):
    def __init__(self, k: int = 16):
        super().__init__()
        self.k = k
        self.input_trans = Linear(3, 8, kernel_dims=1)  # reference Conv1d(3, 8, 1)
        self.layer1 = _edge_layer(16, 32)
        self.layer2 = _edge_layer(64, 64)
        self.layer3 = _edge_layer(128, 64)
        self.layer4 = _edge_layer(128, 128)

    num_features = 128

    def _graph_feature(self, coor_q, x_q, coor_k, x_k) -> torch.Tensor:
        """cat(f_nbr - f_q, f_q) over the kNN of each query (B, Nq, k, 2C)."""
        idx = knn_point(self.k, coor_k, coor_q)
        nbr = index_points(x_k, idx)
        xq = x_q[:, :, None].expand_as(nbr)
        return torch.cat([nbr - xq, xq], dim=-1)

    @staticmethod
    def _fps_downsample(coor, x, num_group: int):
        idx = furthest_point_sample(coor, num_group)
        return index_points(coor, idx), index_points(x, idx)

    def forward(self, x: torch.Tensor, num: Sequence[int]):
        coor = x
        f = self.input_trans(x)
        if self.training:
            nbr = self.input_trans(index_points(coor, knn_point(self.k, coor, coor)))
            fq = f[:, :, None].expand_as(nbr)
            feat = torch.cat([nbr - fq, fq], dim=-1)
        else:
            feat = self._graph_feature(coor, f, coor, f)
        f = self.layer1(feat).amax(dim=2)
        coor_q, f_q = self._fps_downsample(coor, f, num[0])
        f = self.layer2(self._graph_feature(coor_q, f_q, coor, f)).amax(dim=2)
        coor = coor_q
        f = self.layer3(self._graph_feature(coor, f, coor, f)).amax(dim=2)
        coor_q, f_q = self._fps_downsample(coor, f, num[1])
        f = self.layer4(self._graph_feature(coor_q, f_q, coor, f)).amax(dim=2)
        return coor_q, f
