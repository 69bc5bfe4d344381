"""SnowFlakeNet.

Counterpart of ``imgadapointr_tpu/models/snowflakenet.py:28-298``
(reference ``models/external/SnowFlakeNet.py`` and its utils): a PointNet++
encoder (set abstraction over FPS centres and kNN groups) with point
transformers, a seed generator, and three snowflake point deconvolutions
(SPD: skip transformer, point-wise splitting). Train returns (Pc, P1, P2,
P3, partial), eval (P1, P3). The loss is CD-L1 on three FPS-matched
levels plus the partial-matching term, x1000.

Batch-last throughout; the reference's 1x1 convolutions are ``Linear``
layers, its ``ConvTranspose1d`` splittings a Linear reshaped (see the JAX
module's docstring), ``nn.Upsample`` a ``repeat_interleave``. Parameters are
named after the flax tree. The kernels on its path: FPS and its gathers,
kNN (k = 16, the point itself included), the row gather of every
``index_points`` and, in training, the scatter-add of their backward.

Spans (``utils/trace.py``): ``model.sf_extractor``, ``model.sf_seed`` (the
seed generator and the FPS to ``num_p0``), one ``model.sf_spd`` a SPD and,
inside them, ``model.sf_attention`` a vector attention (five a forward).
The counter ``model.sf_attention_rows`` sums the B·N·k neighbour rows the
vector attention builds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, Linear
from ..ops import chamfer_l1, chamfer_l1_pm, fps, index_points, knn_point
from ..utils import trace
from .baselines import Baseline, register_baseline, set_bn_momentum


class MLPConv(nn.Module):
    """Pointwise Linear stack, ReLU between layers, none after the last
    (reference MLP_CONV); layers ``c0``, ``c1``, ..."""

    def __init__(self, in_dim: int, layer_dims):
        super().__init__()
        dims = [in_dim, *layer_dims]
        self.n = len(layer_dims)
        for i in range(self.n):
            self.add_module(f"c{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"c{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class MLPRes(nn.Module):
    """Linear, ReLU, Linear, plus a Linear shortcut (reference MLP_Res)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.shortcut = Linear(in_dim, out_dim)
        self.c1 = Linear(in_dim, hidden_dim)
        self.c2 = Linear(hidden_dim, out_dim)

    def forward(self, x):
        return self.c2(F.relu(self.c1(x))) + self.shortcut(x)


class PosAttention(nn.Module):
    """The vector attention of the point and skip transformers: over each
    point's 16 nearest (itself included), softmax over the neighbours of
    attn_mlp(q - k + pos_emb), summed against v + pos_emb."""

    def __init__(self, dim: int, n_knn: int = 16, pos_hidden_dim: int = 64, attn_mult: int = 4):
        super().__init__()
        self.n_knn = n_knn
        self.pos1 = Linear(3, pos_hidden_dim)
        self.pos_bn = BatchNorm(pos_hidden_dim)
        self.pos2 = Linear(pos_hidden_dim, dim)
        self.attn1 = Linear(dim, dim * attn_mult)
        self.attn_bn = BatchNorm(dim * attn_mult)
        self.attn2 = Linear(dim * attn_mult, dim)

    def forward(self, key, query, value, pos):
        B, N, _ = pos.shape
        trace.count("model.sf_attention_rows", B * N * self.n_knn)
        with trace.span("model.sf_attention"):
            idx = knn_point(self.n_knn, pos, pos)  # each point's own index among them
            qk_rel = query[:, :, None] - index_points(key, idx)  # (B, N, k, dim)
            pos_rel = pos[:, :, None] - index_points(pos, idx)  # (B, N, k, 3)
            pe = self.pos2(F.relu(self.pos_bn(self.pos1(pos_rel))))
            a = self.attn2(F.relu(self.attn_bn(self.attn1(qk_rel + pe))))
            a = a.softmax(dim=2)
            return (a * (value[:, :, None] + pe)).sum(dim=2)


class SFTransformer(nn.Module):
    """Point-transformer block (reference utils Transformer:393-453)."""

    def __init__(self, in_channel: int, dim: int = 256, n_knn: int = 16):
        super().__init__()
        self.linear_start = Linear(in_channel, dim)
        self.conv_key = Linear(dim, dim)
        self.conv_query = Linear(dim, dim)
        self.conv_value = Linear(dim, dim)
        self.attn = PosAttention(dim, n_knn)
        self.linear_end = Linear(dim, in_channel)

    def forward(self, x, pos):
        h = self.linear_start(x)
        agg = self.attn(self.conv_key(h), self.conv_query(h), self.conv_value(h), pos)
        return self.linear_end(agg) + x


class SkipTransformer(nn.Module):
    """Reference SnowFlakeNet.py:19-81."""

    def __init__(self, in_channel: int, dim: int = 256, n_knn: int = 16):
        super().__init__()
        self.mlp_v = MLPRes(2 * in_channel, in_channel, in_channel)
        self.conv_key = Linear(in_channel, dim)
        self.conv_query = Linear(in_channel, dim)
        self.conv_value = Linear(in_channel, dim)
        self.attn = PosAttention(dim, n_knn)
        self.conv_end = Linear(dim, in_channel)

    def forward(self, pos, key, query):
        value = self.mlp_v(torch.cat([key, query], dim=-1))
        agg = self.attn(self.conv_key(key), self.conv_query(query), self.conv_value(value), pos)
        return self.conv_end(agg) + value


class SAModuleKNN(MLPConv):
    """PointNet++ set abstraction over FPS centres and kNN groups (or one
    group of every point), the centred coordinates in front of the features
    (reference utils PointNet_SA_Module_KNN:341-380, no BN): an
    :class:`MLPConv` over each group, then a max over the group."""

    def __init__(self, npoint, nsample, in_dim: int, mlp, group_all: bool = False):
        super().__init__(in_dim + 3, mlp)
        self.npoint, self.nsample, self.group_all = npoint, nsample, group_all

    def forward(self, xyz, points):
        if self.group_all:
            grouped = torch.cat([xyz, points], dim=-1)[:, None]  # (B, 1, N, 3 + f)
            new_xyz = xyz.new_zeros(xyz.shape[0], 1, 3)
        else:
            new_xyz = fps(xyz, self.npoint)
            idx = knn_point(self.nsample, xyz, new_xyz)
            grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None]
            grouped = torch.cat([grouped_xyz, index_points(points, idx)], dim=-1)
        return new_xyz, super().forward(grouped).amax(dim=2)


class FeatureExtractor(nn.Module):
    """Reference SnowFlakeNet.py:83-112."""

    def __init__(self, out_dim: int = 1024):
        super().__init__()
        self.sa1 = SAModuleKNN(512, 16, 3, (64, 128))
        self.t1 = SFTransformer(128, dim=64)
        self.sa2 = SAModuleKNN(128, 16, 128, (128, 256))
        self.t2 = SFTransformer(256, dim=64)
        self.sa3 = SAModuleKNN(None, None, 256, (512, out_dim), group_all=True)

    def forward(self, xyz):
        l1_xyz, l1_points = self.sa1(xyz, xyz)
        l1_points = self.t1(l1_points, l1_xyz)
        l2_xyz, l2_points = self.sa2(l1_xyz, l1_points)
        l2_points = self.t2(l2_points, l2_xyz)
        return self.sa3(l2_xyz, l2_points)[1][:, 0]  # (B, out_dim)


class SeedGenerator(nn.Module):
    """Reference SnowFlakeNet.py:114-134."""

    def __init__(self, dim_feat: int = 512, num_pc: int = 256):
        super().__init__()
        self.num_pc = num_pc
        self.ps = Linear(dim_feat, 128 * num_pc)
        self.mlp1 = MLPRes(128 + dim_feat, 128, 128)
        self.mlp2 = MLPRes(128, 64, 128)
        self.mlp3 = MLPRes(128 + dim_feat, 128, 128)
        self.mlp4a = Linear(128, 64)
        self.mlp4b = Linear(64, 3)

    def forward(self, feat):
        B = feat.shape[0]
        x1 = self.ps(feat).reshape(B, self.num_pc, 128)
        featb = feat[:, None].expand(B, self.num_pc, feat.shape[-1])
        x1 = self.mlp1(torch.cat([x1, featb], dim=-1))
        x3 = self.mlp3(torch.cat([self.mlp2(x1), featb], dim=-1))
        return self.mlp4b(F.relu(self.mlp4a(x3)))  # (B, num_pc, 3)


class SPD(nn.Module):
    """Snowflake point deconvolution (reference SnowFlakeNet.py:137-186)."""

    def __init__(self, dim_feat: int = 512, up_factor: int = 2, i: int = 0, radius: float = 1.0):
        super().__init__()
        self.up, self.i, self.radius = up_factor, i, radius
        self.mlp1 = MLPConv(3, (64, 128))
        self.mlp2 = MLPConv(256 + dim_feat, (256, 128))
        self.skip_transformer = SkipTransformer(128, dim=64)
        self.mlp_ps = MLPConv(128, (64, 32))
        self.ps = Linear(32, 128 * up_factor, bias=False)
        self.mlp_delta_feature = MLPRes(256, 128, 128)
        self.mlp_delta = MLPConv(128, (64, 3))

    def forward(self, pcd_prev, feat_global, k_prev=None):
        B, N, _ = pcd_prev.shape
        f1 = self.mlp1(pcd_prev)
        g = f1.amax(dim=1, keepdim=True)
        feat_1 = torch.cat([f1, g.expand_as(f1), feat_global[:, None].expand(B, N, feat_global.shape[-1])],
                           dim=-1)
        Q = self.mlp2(feat_1)
        H = self.skip_transformer(pcd_prev, k_prev if k_prev is not None else Q, Q)
        feat_child = self.ps(self.mlp_ps(H)).reshape(B, N * self.up, 128)
        K_curr = self.mlp_delta_feature(torch.cat([feat_child, H.repeat_interleave(self.up, dim=1)], dim=-1))
        delta = torch.tanh(self.mlp_delta(F.relu(K_curr))) / self.radius**self.i
        return pcd_prev.repeat_interleave(self.up, dim=1) + delta, K_curr


@register_baseline
class SnowFlakeNet(Baseline):
    """Reference SnowFlakeNet.py:224-290."""

    def __init__(self, config):
        super().__init__()
        dim_feat = int(config.dim_feat)
        self.num_p0 = int(config.num_p0)
        radius = float(config.radius)
        self.feat_extractor = FeatureExtractor(dim_feat)
        self.decoder_coarse = SeedGenerator(dim_feat, int(config.num_pc))
        ups = [1] + [int(u) for u in config.up_factors]
        self.n_up = len(ups)
        for i, up in enumerate(ups):
            self.add_module(f"upper{i}", SPD(dim_feat, up_factor=up, i=i, radius=radius))

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        set_bn_momentum(self, bn_momentum)
        with trace.span("model.sf_extractor"):
            feat = self.feat_extractor(xyz)
        with trace.span("model.sf_seed"):
            pcd = self.decoder_coarse(feat)
            arr = [pcd]
            pcd = fps(torch.cat([pcd, xyz], dim=1), self.num_p0)
        k_prev = None
        for i in range(self.n_up):
            with trace.span("model.sf_spd"):
                pcd, k_prev = getattr(self, f"upper{i}")(pcd, feat, k_prev)
            arr.append(pcd)
        if self.training:
            return (*arr, xyz)
        return arr[1], arr[-1]

    def loss(self, ret, gt: torch.Tensor, epoch_f: float):
        """(CD-L1 of Pc, P1 and P2 against the FPS-matched ground truth plus
        the partial matching, CD-L1 of P3), x1000 (reference SnowFlakeNet.py:253-278)."""
        Pc, P1, P2, P3, partial = ret
        gt_2 = fps(gt, P2.shape[1])
        gt_1 = fps(gt_2, P1.shape[1])
        gt_c = fps(gt_1, Pc.shape[1])
        sparse = chamfer_l1(Pc, gt_c) + chamfer_l1(P1, gt_1) + chamfer_l1(P2, gt_2)
        sparse = sparse + chamfer_l1_pm(partial, P3)
        return sparse * 1000.0, chamfer_l1(P3, gt) * 1000.0

