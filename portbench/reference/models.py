"""The plain reference of the benchmark's two models: AdaPoinTr (PCN recipe)
and ImgEncSegDecAdaPoinTrVariableLoss (ResNet18 image fusion after the
encoder, frozen GDANet fused into the decoder's output), in float32
PyTorch with the plain ops of :mod:`.ops`. Each model's entry (its inputs,
module and FLOP count) is a file of :mod:`.nets`.

A frozen copy of the port's modules for the options these configurations
set (``imgadapointr_tpu_torch/nn/layers.py``, ``nn/blocks.py``,
``nn/grouper.py``, ``nn/heads.py``, ``nn/local_attention.py``'s 'graph'
token, ``nn/image_encoders.py``'s ResNet18, ``models/pctransformer.py``,
``models/adapointr.py``, ``models/fusion.py``, ``models/gdanet.py``,
``models/seg_adapointr.py``, ``models/losses.py``), with the parameter
names of the reference state dict, so one state dict loads into both.
Departures from the port, each the textbook form of the same function:

- the edge convolutions ('graph' blocks, DGCNN, GDANet's blocks 2-3) build
  the (B, N, k, 2C) edge tensor and apply the layer to it, where the port
  commutes the layer past the gather;
- GDANet's SGCAM forms its (B, N, M) attention matrix in train mode too;
- the DGCNN's first layer gathers its input features in train mode as in
  eval mode;
- no dropout, DropPath, LayerScale, tensor or data parallelism: neither
  configuration sets them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

DENOISE_LENGTH = 64
SEG_FEATURES = 128


# ---------------------------------------------------------------- layers
class Linear(nn.Module):
    """``y = x Wᵀ + b``; ``kernel_dims`` trailing 1-dims on the weight, as a
    1x1 Conv1d (1) or Conv2d (2) of the reference state dict."""

    def __init__(self, cin: int, cout: int, bias: bool = True, kernel_dims: int = 0):
        super().__init__()
        self.cin = cin
        self.weight = nn.Parameter(torch.zeros(cout, cin, *([1] * kernel_dims)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.reshape(-1, self.cin), self.bias)


class ConcatDense(Linear):
    """One Linear over ``cat(parts, -1)``."""

    def __init__(self, widths, cout: int, kernel_dims: int = 0):
        super().__init__(sum(widths), cout, True, kernel_dims)
        self.widths = tuple(widths)

    def forward(self, *parts):
        shape = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
        return super().forward(torch.cat([p.expand(*shape, p.shape[-1]) for p in parts], -1))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, batch statistics in train mode."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps, self.momentum = eps, 0.1
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = (x - mean).square().mean(dim=axes)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class GroupNorm(nn.Module):
    def __init__(self, groups: int, n: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        xg = x.reshape(B, -1, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        return ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape) * self.weight + self.bias


def attention(q, k, v, scale, mask=None):
    a = torch.matmul(q, k.transpose(-2, -1)) * scale
    if mask is not None:
        a = a.masked_fill(mask, torch.finfo(a.dtype).min)
    return torch.matmul(a.softmax(dim=-1), v)


class Mlp(nn.Module):
    def __init__(self, cin, hidden, cout):
        super().__init__()
        self.fc1, self.fc2 = Linear(cin, hidden), Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim, heads, qkv_bias):
        super().__init__()
        self.h, self.scale = heads, (dim // heads) ** -0.5
        self.qkv, self.proj = Linear(dim, dim * 3, qkv_bias), Linear(dim, dim)

    def forward(self, x, mask=None):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.h, C // self.h).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], self.scale, mask)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, qkv_bias):
        super().__init__()
        self.h, self.scale = heads, (dim // heads) ** -0.5
        self.q_map, self.k_map, self.v_map = (Linear(dim, dim, qkv_bias) for _ in range(3))
        self.proj = Linear(dim, dim)

    def forward(self, q, v):
        B, N, C = q.shape
        M, H = v.shape[1], self.h

        def heads(t, n):
            return t.reshape(B, n, H, C // H).transpose(1, 2)

        out = attention(heads(self.q_map(q), N), heads(self.k_map(v), M), heads(self.v_map(v), M), self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters, attention from x to mem."""

    def __init__(self, dim, heads=8):
        super().__init__()
        self.h, self.scale = heads, (dim // heads) ** -0.5
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, x, mem):
        B, N, C = x.shape
        M, H = mem.shape[1], self.h
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(t, i, n):
            return F.linear(t, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C]).reshape(B, n, H, C // H).transpose(1, 2)

        out = attention(heads(x, 0, N), heads(mem, 1, M), heads(mem, 2, M), self.scale)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


# ---------------------------------------------------------------- blocks
def edge_features(v_nbr, q):
    """cat(v_nbr - q, q) over the k neighbours (B, N, k, 2C)."""
    qk = q[:, :, None].expand_as(v_nbr)
    return torch.cat([v_nbr - qk, qk], dim=-1)


def two_phase_gather(k, pos, feats, L):
    """The denoise task's gather: the real queries among the real tokens,
    the last L queries among all tokens."""
    idx_r = ops.knn(k, pos[:, :-L], pos[:, :-L])
    idx_n = ops.knn(k, pos, pos[:, -L:])
    return torch.cat([ops.index_points(feats[:, :-L], idx_r), ops.index_points(feats, idx_n)], dim=1)


class GraphAttention(nn.Module):
    """'graph': max_k LeakyReLU(Linear(cat(v_nbr - q, q)))."""

    def __init__(self, dim, k):
        super().__init__()
        self.k = k
        self.knn_map = nn.Sequential(Linear(dim * 2, dim), nn.LeakyReLU(0.2))

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None, denoise_length=0):
        if denoise_length:
            v_nbr = two_phase_gather(self.k, q_pos, q, denoise_length)
        else:
            v = q if v is None else v
            v_pos = q_pos if v_pos is None else v_pos
            idx = ops.knn(self.k, v_pos, q_pos) if idx is None else idx
            v_nbr = ops.index_points(v, idx)
        return self.knn_map(edge_features(v_nbr, q)).amax(dim=2)


def _style(style):
    tokens = style.split("-")
    for t in tokens:
        if t not in ("attn", "graph"):
            raise ValueError(f"the reference has no block token {t!r}")
    return "attn" in tokens, "graph" in tokens


def _norm(dim):
    return nn.LayerNorm(dim, eps=1e-6)


class SelfAttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, qkv_bias, style, k):
        super().__init__()
        has_attn, has_graph = _style(style)
        self.norm1 = _norm(dim)
        self.attn = Attention(dim, heads, qkv_bias) if has_attn else None
        self.local_attn = GraphAttention(dim, k) if has_graph else None
        self.merge_map = Linear(dim * 2, dim) if has_attn and has_graph else None
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, pos, idx):
        nx = self.norm1(x)
        if self.merge_map is not None:
            f = self.merge_map(torch.cat([self.attn(nx), self.local_attn(nx, pos, idx=idx)], -1))
        elif self.attn is not None:
            f = self.attn(nx)
        else:
            f = self.local_attn(nx, pos, idx=idx)
        x = x + f
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, qkv_bias, self_style, cross_style, k):
        super().__init__()
        sa, sg = _style(self_style)
        ca, cg = _style(cross_style)
        self.norm1 = _norm(dim)
        self.self_attn = Attention(dim, heads, qkv_bias) if sa else None
        self.local_self_attn = GraphAttention(dim, k) if sg else None
        self.self_attn_merge_map = Linear(dim * 2, dim) if sa and sg else None
        self.norm_q, self.norm_v = _norm(dim), _norm(dim)
        self.cross_attn = CrossAttention(dim, heads, qkv_bias) if ca else None
        self.local_cross_attn = GraphAttention(dim, k) if cg else None
        self.cross_attn_merge_map = Linear(dim * 2, dim) if ca and cg else None
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, q, v, q_pos, v_pos, self_idx, cross_idx, denoise_length):
        mask = None
        if denoise_length:
            mask = torch.zeros(q.shape[1], q.shape[1], dtype=torch.bool, device=q.device)
            mask[:-denoise_length, -denoise_length:] = True
        nq = self.norm1(q)
        parts = []
        if self.self_attn is not None:
            parts.append(self.self_attn(nq, mask))
        if self.local_self_attn is not None:
            parts.append(self.local_self_attn(nq, q_pos, idx=self_idx, denoise_length=denoise_length))
        q = q + (self.self_attn_merge_map(torch.cat(parts, -1)) if len(parts) == 2 else parts[0])
        nq, nv = self.norm_q(q), self.norm_v(v)
        parts = []
        if self.cross_attn is not None:
            parts.append(self.cross_attn(nq, nv))
        if self.local_cross_attn is not None:
            parts.append(self.local_cross_attn(nq, q_pos, v=nv, v_pos=v_pos, idx=cross_idx))
        q = q + (self.cross_attn_merge_map(torch.cat(parts, -1)) if len(parts) == 2 else parts[0])
        return q + self.mlp(self.norm2(q))


class _Stack(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.k = int(cfg.get("k", 10))
        dim = int(cfg["embed_dim"])
        self.blocks = _Stack([SelfAttnBlock(dim, int(cfg["num_heads"]), float(cfg.get("mlp_ratio", 4.0)),
                                            bool(cfg.get("qkv_bias", True)), s, self.k)
                              for s in cfg["block_style_list"]])
        self.norm = nn.LayerNorm(dim)  # in the state dict, never applied

    def forward(self, x, pos):
        idx = ops.knn(self.k, pos, pos)
        for blk in self.blocks.blocks:
            x = blk(x, pos, idx)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.k = int(cfg.get("k", 10))
        self.blocks = _Stack([
            CrossAttnBlock(int(cfg["embed_dim"]), int(cfg["num_heads"]), float(cfg.get("mlp_ratio", 4.0)),
                           bool(cfg.get("qkv_bias", True)), s, c, self.k)
            for s, c in zip(cfg["self_attn_block_style_list"], cfg["cross_attn_block_style_list"])])

    def forward(self, q, v, q_pos, v_pos, denoise_length):
        self_idx = None if denoise_length else ops.knn(self.k, q_pos, q_pos)
        cross_idx = ops.knn(self.k, v_pos, q_pos)
        for blk in self.blocks.blocks:
            q = blk(q, v, q_pos, v_pos, self_idx, cross_idx, denoise_length)
        return q


# ---------------------------------------------------------------- DGCNN grouper
def _edge_layer(cin, cout):
    return nn.Sequential(Linear(cin, cout, bias=False, kernel_dims=2), GroupNorm(4, cout), nn.LeakyReLU(0.2))


class DGCNNGrouper(nn.Module):
    num_features = 128

    def __init__(self, k=16):
        super().__init__()
        self.k = k
        self.input_trans = Linear(3, 8, kernel_dims=1)
        self.layer1, self.layer2 = _edge_layer(16, 32), _edge_layer(64, 64)
        self.layer3, self.layer4 = _edge_layer(128, 64), _edge_layer(128, 128)

    def graph(self, coor_q, f_q, coor_k, f_k):
        return edge_features(ops.index_points(f_k, ops.knn(self.k, coor_k, coor_q)), f_q)

    def forward(self, x, num):
        coor, f = x, self.input_trans(x)
        f = self.layer1(self.graph(coor, f, coor, f)).amax(dim=2)
        i = ops.fps_indices(coor, num[0])
        coor_q, f_q = ops.index_points(coor, i), ops.index_points(f, i)
        f = self.layer2(self.graph(coor_q, f_q, coor, f)).amax(dim=2)
        coor = coor_q
        f = self.layer3(self.graph(coor, f, coor, f)).amax(dim=2)
        i = ops.fps_indices(coor, num[1])
        coor_q, f_q = ops.index_points(coor, i), ops.index_points(f, i)
        return coor_q, self.layer4(self.graph(coor_q, f_q, coor, f)).amax(dim=2)


# ---------------------------------------------------------------- ResNet18 trunk
class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet18Encoder(nn.Module):
    """torchvision's ResNet18 through layer3: (B, H, W, 3) -> (B, 256, H/16 * W/16)."""

    def __init__(self):
        super().__init__()
        self.base = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), nn.BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)),
            nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128)),
            nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256)))

    def forward(self, img, bn_momentum=0.1):
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = bn_momentum
        return self.base(img.permute(0, 3, 1, 2)).flatten(2)


def image_tokens_width(img_size):
    h = img_size
    for _ in range(4):
        h = (h - 1) // 2 + 1
    return h * h


class AttentionFusion:
    """Five post-LN attention layers over projected features, registered on
    ``owner`` under the reference's names (``cross_attn_img1`` ...)."""

    def __init__(self, owner, tag, dim, feat_dim):
        def add(name, m):
            owner.add_module(name, m)
            return m

        self.proj = add(f"get_better_{tag}_size", nn.Sequential(Linear(feat_dim, dim), nn.GELU()))
        self.cross = [add(f"cross_attn_{tag}{i}", MultiheadAttention(dim)) for i in (1, 2, 3)]
        self.self_attn = [add(f"self_attn_{tag}{i}", MultiheadAttention(dim)) for i in (1, 2)]
        self.norms = [add(f"layer_norm_{tag}{i}", nn.LayerNorm(dim, eps=1e-5)) for i in range(1, 6)]

    def __call__(self, x, feat):
        mem = self.proj(feat)
        n1, n2, n3, n4, n5 = self.norms
        x = n1(self.cross[0](x, mem) + x)
        x = n2(self.self_attn[0](x, x) + x)
        skip = x
        x = n3(self.cross[1](x, mem) + x)
        x = n4(self.self_attn[1](x, x) + x)
        return n5(self.cross[2](x, skip) + x)


# ---------------------------------------------------------------- GDANet (frozen)
def square_distance(src, dst):
    d = -2.0 * torch.matmul(src, dst.transpose(1, 2))
    return d + (src**2).sum(-1, keepdim=True) + (dst**2).sum(-1)[:, None, :]


def top_k(scores, k):
    return torch.sort(-scores, dim=-1, stable=True).indices[..., :k]


def knn_desc(x, k):
    p = -square_distance(x, x)
    idx = top_k(p, k)
    return idx, p, torch.gather(p, -1, idx)


def gdm(x, M, k=64, tau=0.2, sigma=2.0):
    N = x.shape[1]
    M, k = min(M, N), min(k, N)
    idx, p, vals = knn_desc(x, k)
    w = torch.exp(p / (sigma * sigma)) * (torch.sqrt(p.abs()) < tau).to(x.dtype)
    colsum = w.sum(dim=1)
    p_nbr = vals[:, :, 1:]
    w_nbr = torch.exp(p_nbr / (sigma * sigma)) * (torch.sqrt(p_nbr.abs()) < tau).to(x.dtype)
    n = ops.weighted_gather_sum(w_nbr / torch.clamp(colsum, min=1e-12)[:, :, None], idx[:, :, 1:], x)
    pai = ((x - n) ** 2).sum(dim=-1)
    return ops.index_points(x, top_k(pai, M)), ops.index_points(x, top_k(-pai, M))


class SGCAM(nn.Module):
    def __init__(self, c):
        super().__init__()
        inter = max(c // 2, 1)
        self.g, self.theta, self.phi = Linear(c, inter), Linear(c, inter), Linear(c, inter)
        self.W = nn.Sequential(Linear(inter, c), BatchNorm(c))

    def forward(self, x, x2):
        attn = torch.matmul(self.theta(x), self.phi(x2).transpose(1, 2)) / x2.shape[1]
        return self.W(torch.matmul(attn, self.g(x2))) + x


GDANET_BLOCKS = (
    ("conv1", "bn1", 9, 64), ("conv11", "bn11", 64, 64), ("conv12", "bn12", 128, 64),
    ("conv2", "bn2", 2 * 67, 64), ("conv21", "bn21", 64, 64), ("conv22", "bn22", 128, 64),
    ("conv3", "bn3", 2 * 131, 128), ("conv31", "bn31", 128, 128), ("conv32", "bn32", 128, 128),
    ("conv4", "bn4", 256, 512), ("convc", "bnc", 16, 64), ("conv5", "bn5", 256 + 576, 256),
    ("conv6", "bn6", 256, 256), ("conv7", "bn7", 256, 128),
)


class GDANet(nn.Module):
    """Frozen: eval mode whatever its owner's mode, no parameter gradient."""

    def __init__(self, num_classes=50):
        super().__init__()
        for conv, bn, cin, cout in GDANET_BLOCKS:
            self.add_module(conv, nn.Sequential(Linear(cin, cout)))
            self.add_module(bn, BatchNorm(cout))
        self.conv8 = Linear(128, num_classes)
        for name in ("SGCAM_1s", "SGCAM_1g", "SGCAM_2s", "SGCAM_2g"):
            self.add_module(name, SGCAM(64))

    def train(self, mode=True):
        return super().train(False)

    def cb(self, x, i):
        conv, bn = GDANET_BLOCKS[[b[0] for b in GDANET_BLOCKS].index(i)][:2]
        return F.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def edge(self, x, k, conv):
        idx, _, _ = knn_desc(x, min(k, x.shape[1]))
        nbr = ops.index_points(x, idx)
        bn = GDANET_BLOCKS[[b[0] for b in GDANET_BLOCKS].index(conv)][1]
        return F.relu(getattr(self, bn)(getattr(self, conv)(torch.cat([nbr - x[:, :, None], nbr], -1))))

    def forward(self, coor, normals, cls_vec):
        B, N, _ = coor.shape
        idx, _, _ = knn_desc(coor, min(30, N))
        nbr = ops.index_points(coor, idx)
        x1 = torch.cat([nbr - coor[:, :, None], nbr, ops.index_points(normals, idx)], dim=-1)
        x1 = self.cb(self.cb(x1, "conv1"), "conv11").amax(dim=2)
        h, l = gdm(x1, 512)
        x1 = self.cb(torch.cat([self.SGCAM_1s(x1, h), self.SGCAM_1g(x1, l)], -1), "conv12")
        x1t = torch.cat([coor, x1], dim=-1)
        x2 = self.cb(self.edge(x1t, 30, "conv2"), "conv21").amax(dim=2)
        h, l = gdm(x2, 512)
        x2 = self.cb(torch.cat([self.SGCAM_2s(x2, h), self.SGCAM_2g(x2, l)], -1), "conv22")
        x2t = torch.cat([x1t, x2], dim=-1)
        x3 = self.cb(self.cb(self.edge(x2t, 30, "conv3"), "conv31").amax(dim=2), "conv32")
        xx = torch.cat([x1, x2, x3], dim=-1)
        xc = self.cb(xx, "conv4").amax(dim=1)
        clsf = self.cb(cls_vec[:, None, :], "convc")[:, 0]
        glob = torch.cat([xc, clsf], dim=-1)[:, None, :].expand(B, N, 576)
        return self.cb(self.cb(self.cb(torch.cat([xx, glob], -1), "conv5"), "conv6"), "conv7")


def seg_features(gdanet, coor, cls_vec):
    """GDANet's 128-d tap of ``coor``, fed the normals as the reference does:
    the (B, N, 3) buffer read as (B, 3, N), then transposed."""
    nrm = ops.normals(coor, 30)
    B, N, _ = nrm.shape
    return gdanet(coor, nrm.reshape(B, 3, N).transpose(1, 2), cls_vec)


# ---------------------------------------------------------------- models
def _mlp2(a, b, c):
    return nn.Sequential(Linear(a, b), nn.GELU(), Linear(b, c))


class PCTransformer(nn.Module):
    def __init__(self, cfg, use_img=False, use_seg=False):
        super().__init__()
        enc, dec = cfg["encoder_config"], cfg["decoder_config"]
        C, D, gfd = int(enc["embed_dim"]), int(dec["embed_dim"]), int(cfg["global_feature_dim"])
        if cfg["encoder_type"] != "graph" or C != D:
            raise ValueError("the reference takes encoder_type 'graph' with equal encoder and decoder widths")
        self.center_num = tuple(int(n) for n in cfg["center_num"])
        self.num_query = int(cfg["num_query"])
        self.grouper = DGCNNGrouper(16)
        self.pos_embed = _mlp2(3, 128, C)
        self.input_proj = _mlp2(128, 512, C)
        self.encoder = Encoder(enc)
        self.increase_dim = _mlp2(C, 1024, gfd)
        self.coarse_pred = _mlp2(gfd, 1024, 3 * self.num_query)
        self.mlp_query = nn.Sequential(ConcatDense((gfd, 3), 1024), nn.GELU(), Linear(1024, 1024), nn.GELU(),
                                       Linear(1024, D))
        self.query_ranking = nn.Sequential(Linear(3, 256), nn.GELU(), Linear(256, 256), nn.GELU(), Linear(256, 1),
                                           nn.Sigmoid())
        self.decoder = Decoder(dec)
        self.img_fusion = self.seg_fusion = None
        if use_img:
            self.im_encoder = ResNet18Encoder()
            self.img_fusion = AttentionFusion(self, "img", C, image_tokens_width(int(cfg.get("img_size", 224))))
        if use_seg:
            self.segmentator = GDANet(50).requires_grad_(False)
            self.seg_fusion = AttentionFusion(self, "seg", C, SEG_FEATURES)

    def forward(self, xyz, noise=None, img_feat=None, cls_vec=None):
        B = xyz.shape[0]
        coor, f = self.grouper(xyz, self.center_num)
        x = self.encoder(self.input_proj(f) + self.pos_embed(coor), coor)
        if self.img_fusion is not None:
            x = self.img_fusion(x, img_feat)
        gf = self.increase_dim(x).amax(dim=1)
        coarse = self.coarse_pred(gf).reshape(B, self.num_query, 3)
        coarse = torch.cat([coarse, ops.fps(xyz, self.num_query // 2)], dim=1)
        r = self.query_ranking(coarse)[..., 0]
        coarse = ops.index_points(coarse, torch.sort(-r, dim=-1, stable=True).indices[:, :self.num_query])
        L = 0
        if self.training:
            L = DENOISE_LENGTH
            coarse = torch.cat([coarse, ops.jitter(ops.fps(xyz, L), noise)], dim=1)
        q = self.mlp_query[0](gf[:, None, :], coarse)
        q = self.decoder(self.mlp_query[1:](q), x, coarse, coor, L)
        if self.seg_fusion is not None:
            n = q.shape[1] - L
            real = self.seg_fusion(q[:, :n], seg_features(self.segmentator, coarse[:, :n].contiguous(), cls_vec))
            q = torch.cat([real, q[:, n:]], dim=1) if L else real
        return q, coarse, L


class SimpleRebuildFCLayer(nn.Module):
    def __init__(self, dims, step, hidden=512):
        super().__init__()
        self.step = step
        self.layer = Mlp(dims, hidden, step * 3)
        self.layer.fc1 = ConcatDense((dims // 2, dims - dims // 2), hidden)

    def forward(self, rf):
        B, N, _ = rf.shape
        g = rf.amax(dim=1, keepdim=True)
        return self.layer.fc2(F.gelu(self.layer.fc1(g, rf))).reshape(B, N, self.step, 3)


def cycle_alpha(epoch, step_size=5, max_lr=1.0, base_lr=0.01, gamma=0.995):
    e = float(epoch)
    cycle = math.floor(1.0 + e / (2 * step_size))
    x = abs(e / step_size - 2 * cycle + 1)
    return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) * gamma**e


class AdaPoinTr(nn.Module):
    """AdaPoinTr; with ``use_img`` / ``use_seg`` the image-encoder and
    segmentation-decoder superset. Eval: (coarse, fine); train: (pred_coarse,
    denoised_coarse, denoised_fine, pred_fine)."""

    def __init__(self, cfg, use_img=False, use_seg=False, variable_loss=False):
        super().__init__()
        if cfg["decoder_type"] != "fc":
            raise ValueError("the reference takes decoder_type 'fc'")
        D = int(cfg["decoder_config"]["embed_dim"])
        self.use_img, self.use_seg, self.variable_loss = use_img, use_seg, variable_loss
        self.base_model = PCTransformer(cfg, use_img, use_seg)
        self.increase_dim = nn.Sequential(Linear(D, 1024, kernel_dims=1), BatchNorm(1024), nn.LeakyReLU(0.2),
                                          Linear(1024, 1024, kernel_dims=1))
        self.reduce_map = ConcatDense((1024, D, 3), D)
        self.factor = int(cfg["num_points"]) // int(cfg["num_query"])
        self.decode_head = SimpleRebuildFCLayer(D * 2, self.factor)

    def forward(self, xyz, img=None, cls_vec=None, bn_momentum=0.1, noise=None):
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.momentum = bn_momentum
        img_feat = self.base_model.im_encoder(img, bn_momentum) if self.use_img else None
        q, coarse, L = self.base_model(xyz, noise, img_feat, cls_vec)
        B = q.shape[0]
        gf = self.increase_dim(q).amax(dim=1)
        rebuild = self.decode_head(self.reduce_map(gf[:, None], q, coarse)) + coarse[:, :, None]
        if not self.training:
            return coarse, rebuild.reshape(B, -1, 3)
        return coarse[:, :-L], coarse[:, -L:], rebuild[:, -L:].reshape(B, -1, 3), rebuild[:, :-L].reshape(B, -1, 3)

    def loss(self, ret, gt, epoch_f):
        """(loss_denoised, loss_recon)."""
        pred_coarse, denoised_coarse, denoised_fine, pred_fine = ret
        with torch.no_grad():
            target = ops.index_points(gt, ops.knn(self.factor, gt, denoised_coarse)).reshape(gt.shape[0], -1, 3)
        alpha = cycle_alpha(epoch_f + 5) if self.variable_loss else 1.0
        return (0.5 * ops.chamfer_l1(denoised_fine, target),
                alpha * ops.chamfer_l1(pred_coarse, gt) + ops.chamfer_l1(pred_fine, gt))

