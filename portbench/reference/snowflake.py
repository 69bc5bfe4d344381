"""The plain reference of SnowFlakeNet (Xiang et al., "SnowflakeNet: Point
Cloud Completion by Snowflake Point Deconvolution with Skip-Transformer",
ICCV 2021, arXiv:2108.04444; PoinTr's ``models/SnowFlakeNet.py`` and the
SnowflakeNet ``models/utils.py`` it imports), in float32 PyTorch with the
plain ops of :mod:`.ops`, and its FLOP count.

A PointNet++ feature extractor (set abstraction over FPS centres and kNN
groups, with point transformers after the first two), a seed generator,
the FPS of seeds ∪ partial to ``num_p0`` points, and one snowflake point
deconvolution (SPD: skip-transformer, point-wise splitting, a ``tanh``
displacement over ``radius**i``) per up factor (a first of factor 1).
Train returns (Pc, P1, P2, P3, partial), eval (P1, P3). The loss is
CD-L1 of Pc, P1 and P2 against the FPS-matched ground truth plus the
partial-matching term, and CD-L1 of P3, each x1000.

The vector attention of both transformers: each point takes its 16
nearest points (itself among them); ``pos_mlp`` (Linear, BatchNorm, ReLU,
Linear) embeds ``pos_i - pos_j``; ``attn_mlp`` (Linear to 4 x dim,
BatchNorm, ReLU, Linear) maps ``q_i - k_j + pos_emb`` to one weight a
channel; the softmax runs over the neighbours, per channel; the weights
multiply ``v_i + pos_emb`` (upstream adds the point's own value, not the
neighbour's) and sum over the neighbours.

Departures from upstream, each the same function in another layout, so
that one state dict loads into this module and the port's
(``imgadapointr_tpu_torch/models/snowflakenet.py``):

- channels last, (B, N, C), where upstream runs (B, C, N);
- every 1x1 ``Conv1d`` / ``Conv2d`` is a :class:`~.models.Linear` and every
  ``BatchNorm2d`` a :class:`~.models.BatchNorm` over the last axis;
- the seed generator's ``ConvTranspose1d(dim_feat, 128, num_pc)`` on a
  length-1 input is a Linear to ``num_pc x 128`` reshaped to (B, num_pc,
  128), with a bias per output entry where upstream has one per channel;
- the SPD's ``ConvTranspose1d(32, 128, up, up, bias=False)`` is a Linear
  to ``up x 128`` reshaped to (B, N x up, 128), the same product with the
  weight's axes in another order;
- ``nn.Upsample(scale_factor=up)`` is ``repeat_interleave``;
- the CD-L1 is PoinTr's (``sqrt`` of the squared distance floored at
  1e-24, :func:`.ops.chamfer_l1`), where SnowflakeNet's own repository
  floors at 1e-9; the partial-matching term is its one direction
  (partial to P3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .flops import Count
from .models import BatchNorm, Linear

N_KNN = 16
POS_HIDDEN = 64
ATTN_MULT = 4


class MLP(nn.Module):
    """Upstream ``MLP_CONV``: Linears with ReLU between, none after the last;
    layers ``c0``, ``c1``, ..."""

    def __init__(self, in_dim, dims):
        super().__init__()
        dims = [in_dim, *dims]
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"c{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"c{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class MLPRes(nn.Module):
    """Upstream ``MLP_Res``: ``conv_2(relu(conv_1(x))) + conv_shortcut(x)``."""

    def __init__(self, in_dim, hidden, out_dim):
        super().__init__()
        self.shortcut, self.c1, self.c2 = Linear(in_dim, out_dim), Linear(in_dim, hidden), Linear(hidden, out_dim)

    def forward(self, x):
        return self.c2(F.relu(self.c1(x))) + self.shortcut(x)


def neighbour_softmax(a: torch.Tensor) -> torch.Tensor:
    """The attention weights of (B, N, k, C) logits: a softmax over the k
    neighbours, per channel."""
    return torch.softmax(a, dim=2)


class VectorAttention(nn.Module):
    """The vector attention of the point and skip transformers (module
    docstring), given the projected key, query and value and the points."""

    def __init__(self, dim):
        super().__init__()
        self.pos1, self.pos_bn, self.pos2 = Linear(3, POS_HIDDEN), BatchNorm(POS_HIDDEN), Linear(POS_HIDDEN, dim)
        self.attn1, self.attn_bn = Linear(dim, ATTN_MULT * dim), BatchNorm(ATTN_MULT * dim)
        self.attn2 = Linear(ATTN_MULT * dim, dim)

    def forward(self, key, query, value, pos):
        idx = ops.knn(N_KNN, pos, pos)
        qk_rel = query[:, :, None] - ops.index_points(key, idx)
        pos_rel = pos[:, :, None] - ops.index_points(pos, idx)
        pos_emb = self.pos2(F.relu(self.pos_bn(self.pos1(pos_rel))))
        weights = neighbour_softmax(self.attn2(F.relu(self.attn_bn(self.attn1(qk_rel + pos_emb)))))
        return (weights * (value[:, :, None] + pos_emb)).sum(dim=2)


class PointTransformer(nn.Module):
    """Upstream utils ``Transformer``: ``linear_end(attention(linear_start(x))) + x``."""

    def __init__(self, in_channel, dim):
        super().__init__()
        self.linear_start = Linear(in_channel, dim)
        self.conv_key, self.conv_query, self.conv_value = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.attn = VectorAttention(dim)
        self.linear_end = Linear(dim, in_channel)

    def forward(self, x, pos):
        h = self.linear_start(x)
        return self.linear_end(self.attn(self.conv_key(h), self.conv_query(h), self.conv_value(h), pos)) + x


class SkipTransformer(nn.Module):
    """Upstream ``SkipTransformer``: the value is ``mlp_v(cat(key, query))``
    and the block adds it back."""

    def __init__(self, in_channel, dim):
        super().__init__()
        self.mlp_v = MLPRes(2 * in_channel, in_channel, in_channel)
        self.conv_key, self.conv_query = Linear(in_channel, dim), Linear(in_channel, dim)
        self.conv_value = Linear(in_channel, dim)
        self.attn = VectorAttention(dim)
        self.conv_end = Linear(dim, in_channel)

    def forward(self, pos, key, query):
        value = self.mlp_v(torch.cat([key, query], dim=-1))
        agg = self.attn(self.conv_key(key), self.conv_query(query), self.conv_value(value), pos)
        return self.conv_end(agg) + value


class SetAbstraction(MLP):
    """Upstream ``PointNet_SA_Module_KNN`` without BN (``if_bn=False``): each
    FPS centre's kNN group, its coordinates relative to the centre in front
    of the features, through the MLP, then a max over the group; with
    ``group_all`` one group of every point, coordinates as they are."""

    def __init__(self, npoint, nsample, in_dim, dims, group_all=False):
        super().__init__(in_dim + 3, dims)
        self.npoint, self.nsample, self.group_all = npoint, nsample, group_all

    def forward(self, xyz, points):
        if self.group_all:
            return None, super().forward(torch.cat([xyz, points], dim=-1)).amax(dim=1)
        centres = ops.fps(xyz, self.npoint)
        idx = ops.knn(self.nsample, xyz, centres)
        grouped = torch.cat([ops.index_points(xyz, idx) - centres[:, :, None], ops.index_points(points, idx)], -1)
        return centres, super().forward(grouped).amax(dim=2)


class FeatureExtractor(nn.Module):
    def __init__(self, out_dim):
        super().__init__()
        self.sa1 = SetAbstraction(512, 16, 3, (64, 128))
        self.t1 = PointTransformer(128, 64)
        self.sa2 = SetAbstraction(128, 16, 128, (128, 256))
        self.t2 = PointTransformer(256, 64)
        self.sa3 = SetAbstraction(None, None, 256, (512, out_dim), group_all=True)

    def forward(self, xyz):
        l1_xyz, l1 = self.sa1(xyz, xyz)
        l1 = self.t1(l1, l1_xyz)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        return self.sa3(l2_xyz, self.t2(l2, l2_xyz))[1]


class SeedGenerator(nn.Module):
    def __init__(self, dim_feat, num_pc):
        super().__init__()
        self.num_pc = num_pc
        self.ps = Linear(dim_feat, 128 * num_pc)
        self.mlp1 = MLPRes(128 + dim_feat, 128, 128)
        self.mlp2 = MLPRes(128, 64, 128)
        self.mlp3 = MLPRes(128 + dim_feat, 128, 128)
        self.mlp4a, self.mlp4b = Linear(128, 64), Linear(64, 3)

    def forward(self, feat):
        B = feat.shape[0]
        feat_n = feat[:, None].expand(B, self.num_pc, feat.shape[-1])
        x1 = self.mlp1(torch.cat([self.ps(feat).reshape(B, self.num_pc, 128), feat_n], dim=-1))
        x3 = self.mlp3(torch.cat([self.mlp2(x1), feat_n], dim=-1))
        return self.mlp4b(F.relu(self.mlp4a(x3)))


class SPD(nn.Module):
    def __init__(self, dim_feat, up_factor, i, radius):
        super().__init__()
        self.up, self.i, self.radius = up_factor, i, radius
        self.mlp1 = MLP(3, (64, 128))
        self.mlp2 = MLP(256 + dim_feat, (256, 128))
        self.skip_transformer = SkipTransformer(128, 64)
        self.mlp_ps = MLP(128, (64, 32))
        self.ps = Linear(32, 128 * up_factor, bias=False)
        self.mlp_delta_feature = MLPRes(256, 128, 128)
        self.mlp_delta = MLP(128, (64, 3))

    def forward(self, pcd_prev, feat_global, k_prev):
        B, N, _ = pcd_prev.shape
        f1 = self.mlp1(pcd_prev)
        Q = self.mlp2(torch.cat([f1, f1.amax(dim=1, keepdim=True).expand_as(f1),
                                 feat_global[:, None].expand(B, N, feat_global.shape[-1])], dim=-1))
        H = self.skip_transformer(pcd_prev, Q if k_prev is None else k_prev, Q)
        feat_child = self.ps(self.mlp_ps(H)).reshape(B, N * self.up, 128)
        K_curr = self.mlp_delta_feature(torch.cat([feat_child, H.repeat_interleave(self.up, dim=1)], dim=-1))
        delta = torch.tanh(self.mlp_delta(F.relu(K_curr))) / self.radius**self.i
        return pcd_prev.repeat_interleave(self.up, dim=1) + delta, K_curr


def partial_matching(partial: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean distance from each partial point to its nearest predicted point."""
    d = ops.sqdist(partial - ops.index_points(pred, ops.nearest(partial, pred))).clamp_min(0.0)
    return torch.sqrt(d.clamp_min(1e-24)).mean()


class SnowFlakeNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        dim_feat, self.num_p0, radius = int(cfg["dim_feat"]), int(cfg["num_p0"]), float(cfg["radius"])
        self.feat_extractor = FeatureExtractor(dim_feat)
        self.decoder_coarse = SeedGenerator(dim_feat, int(cfg["num_pc"]))
        self.ups = [1] + [int(u) for u in cfg["up_factors"]]
        for i, up in enumerate(self.ups):
            self.add_module(f"upper{i}", SPD(dim_feat, up, i, radius))

    def forward(self, xyz, bn_momentum=0.1, noise=None):
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.momentum = bn_momentum
        feat = self.feat_extractor(xyz)
        pcd = self.decoder_coarse(feat)
        out = [pcd]
        pcd, k_prev = ops.fps(torch.cat([pcd, xyz], dim=1), self.num_p0), None
        for i in range(len(self.ups)):
            pcd, k_prev = getattr(self, f"upper{i}")(pcd, feat, k_prev)
            out.append(pcd)
        return (*out, xyz) if self.training else (out[1], out[-1])

    def loss(self, ret, gt, epoch_f):
        """(CD-L1 of Pc, P1, P2 against the FPS-matched gt + partial matching,
        CD-L1 of P3), x1000."""
        Pc, P1, P2, P3, partial = ret
        gt_2 = ops.fps(gt, P2.shape[1])
        gt_1 = ops.fps(gt_2, P1.shape[1])
        gt_c = ops.fps(gt_1, Pc.shape[1])
        sparse = ops.chamfer_l1(Pc, gt_c) + ops.chamfer_l1(P1, gt_1) + ops.chamfer_l1(P2, gt_2)
        return (sparse + partial_matching(partial, P3)) * 1000.0, ops.chamfer_l1(P3, gt) * 1000.0


# ------------------------------------------------------------ FLOP count
class SnowflakeCount(Count):
    """:class:`~.flops.Count` with the vector attention's elementwise work
    kept apart (``elementwise``, forward FLOPs; its backward counts twice)."""

    def __init__(self):
        super().__init__()
        self.elementwise = 0.0

    def ew(self, flops: float) -> None:
        self.elementwise += flops
        self.fwd += flops
        self.bwd += 2.0 * flops


def _attention(c: SnowflakeCount, n: int, dim: int, pos_grad: bool) -> None:
    """One vector attention over n points: its four Linears over the n·k
    neighbour rows, then per row the relative key and position (dim + 3),
    the sum with the embedding (dim), two BatchNorms' normalise and affine
    (4 a channel), the softmax (max, subtract, exp, sum, divide: 5 a
    channel), the value plus the embedding (dim) and the weighted sum (2
    a channel). ReLU's compares are not counted."""
    rows = n * N_KNN
    c.linear(rows, 3, POS_HIDDEN, x_grad=pos_grad)
    c.linear(rows, POS_HIDDEN, dim)
    c.linear(rows, dim, ATTN_MULT * dim)
    c.linear(rows, ATTN_MULT * dim, dim)
    c.ew(rows * (3 + dim + dim + 4 * (POS_HIDDEN + ATTN_MULT * dim) + 5 * dim + dim + 2 * dim))


def _mlp(c: Count, rows: int, in_dim: int, dims, x_grad: bool = True) -> None:
    for cout in dims:
        c.linear(rows, in_dim, cout, x_grad=x_grad)
        in_dim, x_grad = cout, True


def _res(c: Count, rows: int, in_dim: int, hidden: int, out_dim: int) -> None:
    c.linear(rows, in_dim, out_dim)
    c.linear(rows, in_dim, hidden)
    c.linear(rows, hidden, out_dim)


def count(cfg: dict, n_points: int) -> SnowflakeCount:
    """FLOPs of one cloud of ``n_points`` through SnowFlakeNet under its
    ``model`` config: every Linear over its rows (two FLOPs a multiply-add)
    and the vector attention's elementwise work (:func:`_attention`); the
    backward computes each weight's gradient and each input's where the
    input needs one (not the raw partial's, nor positions drawn from it)."""
    dim_feat, num_pc, num_p0 = int(cfg["dim_feat"]), int(cfg["num_pc"]), int(cfg["num_p0"])
    c = SnowflakeCount()
    # feature extractor
    _mlp(c, 512 * 16, 6, (64, 128), x_grad=False)
    for n, width in ((512, 128), (128, 256)):
        if n == 128:
            _mlp(c, 128 * 16, 128 + 3, (128, 256))
        c.linear(n, width, 64)
        for _ in range(3):
            c.linear(n, 64, 64)
        _attention(c, n, 64, pos_grad=False)
        c.linear(n, 64, width)
    _mlp(c, 128, 256 + 3, (512, dim_feat))
    # seed generator
    c.linear(1, dim_feat, 128 * num_pc)
    _res(c, num_pc, 128 + dim_feat, 128, 128)
    _res(c, num_pc, 128, 64, 128)
    _res(c, num_pc, 128 + dim_feat, 128, 128)
    _mlp(c, num_pc, 128, (64, 3))
    # SPDs
    n = num_p0
    for up in [1] + [int(u) for u in cfg["up_factors"]]:
        _mlp(c, n, 3, (64, 128))
        _mlp(c, n, 256 + dim_feat, (256, 128))
        _res(c, n, 256, 128, 128)
        for _ in range(3):
            c.linear(n, 128, 64)
        _attention(c, n, 64, pos_grad=True)
        c.linear(n, 64, 128)
        _mlp(c, n, 128, (64, 32))
        c.linear(n, 32, 128 * up)
        _res(c, n * up, 256, 128, 128)
        _mlp(c, n * up, 128, (64, 3))
        n *= up
    return c


def step_flops(cfg: dict, n_points: int, train: bool) -> float:
    """FLOPs of one cloud: the forward, plus the backward in training."""
    c = count(cfg, n_points)
    return c.fwd + (c.bwd if train else 0.0)
