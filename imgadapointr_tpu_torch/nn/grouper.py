"""The point front ends: the DGCNN grouper (``encoder_type: graph``) and
the per-group PointNet of ``encoder_type: pn``.

``DGCNNGrouper`` (counterpart of ``imgadapointr_tpu/nn/grouper.py:22-89``):

Four edge convolutions (1x1 conv, GroupNorm(4, eps 1e-5), LeakyReLU(0.2),
max over k = 16 neighbours) and two FPS downsamples. Input (B, N, 3);
output (coor (B, num[-1], 3), feat (B, num[-1], 128)). In train mode layer
1 gathers the raw coordinates and applies ``input_trans`` after the gather
(``grouper.py:59-74``): equal in value to the eval form, and the gathered
table needs no gradient, so no (B, N, k, 8) -> (B, N, 8) scatter-add runs
in the backward.

``SimpleEncoder`` (``imgadapointr_tpu/nn/grouper.py:96-145``, reference
base_blocks.py:632-698): FPS to ``center_num[-1]`` centres, their k = 32
nearest input points, and a per-group PointNet (``embedding``, the
reference's ``PCNEncoder``: ``first_conv`` 3 -> 128 -> BN -> ReLU -> 256,
max, ``second_conv`` over cat(max, feature) 512 -> BN -> ReLU -> C, max).
Its BatchNorms take the call's scheduled momentum and the two-pass batch
variance (``nn/layers.py:BatchNorm``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import fps, furthest_point_sample, index_points, knn_point
from .layers import BatchNorm, ConcatDense, GroupNorm, Linear


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


class PCNEncoder(nn.Module):
    """Per-group PointNet: (B, G, N, 3) point groups -> (B, G, C)."""

    def __init__(self, encoder_channel: int):
        super().__init__()
        self.encoder_channel = encoder_channel
        # reference Sequential(Conv1d(3, 128, 1), BatchNorm1d(128), ReLU, Conv1d(128, 256, 1))
        self.first_conv = nn.Sequential(Linear(3, 128, kernel_dims=1), BatchNorm(128), nn.ReLU(),
                                        Linear(128, 256, kernel_dims=1))
        # reference Conv1d(512, 512, 1) over cat(global, feature): the global
        # part is contracted once per group, before it is broadcast
        self.second_conv = nn.Sequential(ConcatDense((256, 256), 512, kernel_dims=1), BatchNorm(512),
                                         nn.ReLU(), Linear(512, encoder_channel, kernel_dims=1))

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        B, G, N, _ = point_groups.shape
        f = self.first_conv(point_groups.reshape(B * G, N, 3))  # (BG, N, 256)
        f = self.second_conv[0](f.amax(dim=1, keepdim=True), f)
        f = self.second_conv[1:](f).amax(dim=1)  # (BG, C)
        return f.reshape(B, G, self.encoder_channel)


class SimpleEncoder(nn.Module):
    """``encoder_type: pn``: FPS centres, their k nearest points, and
    :class:`PCNEncoder` over each group. Input (B, N, 3); output (centres
    (B, G, 3), features (B, G, embed_dims))."""

    def __init__(self, k: int = 32, embed_dims: int = 128):
        super().__init__()
        self.k = k
        self.num_features = embed_dims
        self.embedding = PCNEncoder(embed_dims)

    def forward(self, xyz: torch.Tensor, n_group) -> tuple:
        if isinstance(n_group, (list, tuple)):
            n_group = n_group[-1]
        center = fps(xyz, n_group)
        neighborhood = index_points(xyz, knn_point(self.k, xyz, center))  # (B, G, k, 3)
        return center, self.embedding(neighborhood)
