"""GDANet, the part-segmentation network whose 128-d per-point features the
segmentation models fuse (frozen).

Counterpart of ``imgadapointr_tpu/models/gdanet.py:27-251`` (reference
``models/segmentation/GDANet_ptseg.py:7-131`` and ``GDANet_util.py``):
three edge-conv blocks, the first two followed by the Geometry-Disentangle
Module (:func:`gdm`, which splits the points into the sharp and the gentle
ones by the graph Laplacian) and two SGCAM attentions; a 50-way head whose
penultimate 128-d features are the tap.

Frozen: its parameters take no gradient (``requires_grad`` is off from
the moment the owning model is built), every BatchNorm runs on its running
statistics whatever the module's mode (:meth:`GDANet.train` keeps it in
eval mode), and its dropouts are the identity, as in the JAX package. The
gradient does flow through it into its input points (the reference does
not detach, ``imgadapointr_tpu/models/seg_adapointr.py:64-81``): the
selections are constants, the gathers carry it. The GDM's neighbour sum
only ranks the points, so no gradient reaches the weighted gather-sum's
backward. Parameter names follow the reference checkpoint: ``convN.0``
for the pointwise convolution of a block and ``bnN`` for its BatchNorm,
``conv8`` for the head, ``SGCAM_*.{g,theta,phi,W.0,W.1}``. Pointwise weights are ``(out, in)``;
the reference's trailing 1-dims are dropped when a checkpoint is loaded
(``tools/convert.py:load_gdanet_weights``).

GDANet ranks its feature-space neighbours as the JAX package does: by the
matmul form ``-2 x·y + |x|² + |y|²`` in full float32 (TF32 off) and a
top-k with ties to the lower index, which here is a stable sort. The
normals' kNN (``ops/normals.py``) stays on the kNN kernel's diff form,
again as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, Linear
from ..ops import index_points, weighted_gather_sum


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M): ``-2 src·dstᵀ + |src|² + |dst|²``
    (``imgadapointr_tpu/ops/pointops.py:22-51``)."""
    d = -2.0 * torch.matmul(src, dst.transpose(1, 2))
    d = d + (src**2).sum(dim=-1, keepdim=True)
    return d + (dst**2).sum(dim=-1)[:, None, :]


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(scores, k)[1]``: the k largest along the last axis,
    descending, ties to the lower index (a stable ascending sort of the
    negated scores)."""
    return torch.sort(-scores, dim=-1, stable=True).indices[..., :k]


def _knn_desc(x: torch.Tensor, k: int):
    """(idx (B, N, k), p = -sqdist (B, N, N), vals = p at idx): the k nearest
    in feature space, nearest first (``gdanet.py:27-33``)."""
    p = -square_distance(x, x)
    idx = top_k_indices(p, k)
    return idx, p, torch.gather(p, -1, idx)


def local_operator_withnorm(x: torch.Tensor, norm: torch.Tensor, k: int) -> torch.Tensor:
    """cat(neighbour - x, neighbour, neighbour's normal): (B, N, 3) and
    (B, N, 3) -> (B, N, k, 9) (``gdanet.py:48-56``)."""
    idx, _, _ = _knn_desc(x, k)
    nbr = index_points(x, idx)
    return torch.cat([nbr - x[:, :, None], nbr, index_points(norm, idx)], dim=-1)


def gdm(x: torch.Tensor, M: int, k: int = 64, tau: float = 0.2, sigma: float = 2.0):
    """Geometry-Disentangle Module (``gdanet.py:59-85``): (sharp, gentle),
    each (B, M, C), the M points of x (B, N, C) with the largest / smallest
    ``|x_i - Σ_j Â_ij x_j|²`` over the local normalised adjacency Â. The
    neighbour sum is the weighted-gather-sum kernel."""
    B, N, C = x.shape
    M, k = min(M, N), min(k, N)
    idx, p, vals = _knn_desc(x, k)
    w = torch.exp(p / (sigma * sigma)) * (torch.sqrt(p.abs()) < tau).to(x.dtype)
    colsum = w.sum(dim=1)  # Σ_r w[r, i]
    # Â at the k - 1 non-self neighbours, from the values the top-k returned
    p_nbr = vals[:, :, 1:]
    w_nbr = torch.exp(p_nbr / (sigma * sigma)) * (torch.sqrt(p_nbr.abs()) < tau).to(x.dtype)
    a_local = w_nbr / torch.clamp(colsum, min=1e-12)[:, :, None]
    n = weighted_gather_sum(a_local.contiguous(), idx[:, :, 1:].contiguous(), x.contiguous())
    pai = ((x - n) ** 2).sum(dim=-1)  # (B, N)
    return index_points(x, top_k_indices(pai, M)), index_points(x, top_k_indices(-pai, M))


class SGCAM(nn.Module):
    """Sharp-Gentle Complementary Attention (``gdanet.py:119-165``):
    non-local attention from x (B, N, C) onto x2 (B, M, C) as
    ``W = θφᵀ / M`` then ``W g``, a pointwise projection, a BatchNorm whose
    scale starts at zero, and the residual.

    ``commute=True`` takes the product as ``θ (φᵀ g) / M`` (``:147-149``):
    no softmax sits between the two products, so the forms are equal up to
    rounding, and the (B, N, M) matrix is never formed, forward or
    backward. The segmentation models commute in train mode and keep the
    reference's order in eval, the choice of the JAX package's accelerator
    path (``seg_adapointr.py:51-61``); the port makes it on every device."""

    def __init__(self, in_channels: int):
        super().__init__()
        inter = max(in_channels // 2, 1)
        self.g = Linear(in_channels, inter)
        self.theta = Linear(in_channels, inter)
        self.phi = Linear(in_channels, inter)
        self.W = nn.Sequential(Linear(inter, in_channels), BatchNorm(in_channels))
        nn.init.zeros_(self.W[1].weight)

    def forward(self, x: torch.Tensor, x2: torch.Tensor, commute: bool = False) -> torch.Tensor:
        g, theta, phi = self.g(x2), self.theta(x), self.phi(x2)
        if commute:
            y = torch.matmul(theta, torch.matmul(phi.transpose(1, 2), g)) / x2.shape[1]
        else:
            attn = torch.matmul(theta, phi.transpose(1, 2)) / x2.shape[1]  # (B, N, M)
            y = torch.matmul(attn, g)
        return self.W(y) + x


# (conv, BatchNorm, in, out) of the pointwise blocks, reference names
BLOCKS = (
    ("conv1", "bn1", 9, 64), ("conv11", "bn11", 64, 64), ("conv12", "bn12", 128, 64),
    ("conv2", "bn2", 2 * 67, 64), ("conv21", "bn21", 64, 64), ("conv22", "bn22", 128, 64),
    ("conv3", "bn3", 2 * 131, 128), ("conv31", "bn31", 128, 128), ("conv32", "bn32", 128, 128),
    ("conv4", "bn4", 256, 512), ("convc", "bnc", 16, 64), ("conv5", "bn5", 256 + 576, 256),
    ("conv6", "bn6", 256, 256), ("conv7", "bn7", 256, 128),
)


class GDANet(nn.Module):
    """(coor (B, N, 3), normals (B, N, 3), class one-hot (B, 16)) ->
    (features (B, N, 128), log-probabilities (B, N, num_classes))."""

    def __init__(self, num_classes: int = 50):
        super().__init__()
        self._bn = {}
        for conv, bn, cin, cout in BLOCKS:
            self.add_module(conv, nn.Sequential(Linear(cin, cout)))
            self.add_module(bn, BatchNorm(cout))
            self._bn[conv] = bn
        self.conv8 = Linear(128, num_classes)
        for name in ("SGCAM_1s", "SGCAM_1g", "SGCAM_2s", "SGCAM_2g"):
            self.add_module(name, SGCAM(64))

    def train(self, mode: bool = True):
        """Frozen: stays in eval mode, so BatchNorm reads running statistics."""
        return super().train(False)

    def _conv_bn(self, x: torch.Tensor, conv: str) -> torch.Tensor:
        return F.relu(getattr(self, self._bn[conv])(getattr(self, conv)(x)))

    def _edge_conv_commuted(self, x: torch.Tensor, k: int, conv: str) -> torch.Tensor:
        """The edge features cat(nbr - x, nbr) through one (2C -> ch)
        pointwise convolution ``[W1 W2]``, with the product taken before the
        gather: ``(x (W1 + W2)ᵀ + b)[nbr] - x W1ᵀ`` (``gdanet.py:174-196``),
        so the gather moves ch channels instead of 2C. Then BatchNorm; the
        caller applies the ReLU."""
        lin = getattr(self, conv)[0]
        C = x.shape[-1]
        w1, w2 = lin.weight[:, :C], lin.weight[:, C:]
        u = F.linear(x, w1 + w2, lin.bias)
        v = F.linear(x, w1)
        idx, _, _ = _knn_desc(x, min(k, x.shape[1]))
        return getattr(self, self._bn[conv])(index_points(u, idx) - v[:, :, None, :])

    def forward(self, coor: torch.Tensor, normals: torch.Tensor, cls_vec: torch.Tensor,
                commute: bool = False):
        """``commute``: the SGCAMs' reassociated product (:class:`SGCAM`)."""
        B, N, _ = coor.shape
        # block 1, with the normals
        x1 = local_operator_withnorm(coor, normals, k=min(30, N))  # (B, N, k, 9)
        x1 = self._conv_bn(self._conv_bn(x1, "conv1"), "conv11").amax(dim=2)  # (B, N, 64)
        x1h, x1l = gdm(x1, M=512)
        x1h, x1l = self.SGCAM_1s(x1, x1h, commute), self.SGCAM_1g(x1, x1l, commute)
        x1 = self._conv_bn(torch.cat([x1h, x1l], dim=-1), "conv12")

        # block 2
        x1t = torch.cat([coor, x1], dim=-1)  # (B, N, 67)
        x2 = self._conv_bn(F.relu(self._edge_conv_commuted(x1t, 30, "conv2")), "conv21").amax(dim=2)
        x2h, x2l = gdm(x2, M=512)
        x2h, x2l = self.SGCAM_2s(x2, x2h, commute), self.SGCAM_2g(x2, x2l, commute)
        x2 = self._conv_bn(torch.cat([x2h, x2l], dim=-1), "conv22")

        # block 3
        x2t = torch.cat([x1t, x2], dim=-1)  # (B, N, 131)
        x3 = self._conv_bn(F.relu(self._edge_conv_commuted(x2t, 30, "conv3")), "conv31").amax(dim=2)
        x3 = self._conv_bn(x3, "conv32")

        xx = torch.cat([x1, x2, x3], dim=-1)  # (B, N, 256)
        xc = self._conv_bn(xx, "conv4").amax(dim=1)  # (B, 512)
        clsf = self._conv_bn(cls_vec[:, None, :], "convc")[:, 0]  # (B, 64)
        glob = torch.cat([xc, clsf], dim=-1)[:, None, :].expand(B, N, 576)
        x = self._conv_bn(torch.cat([xx, glob], dim=-1), "conv5")
        x = self._conv_bn(x, "conv6")
        feat = self._conv_bn(x, "conv7")  # the 128-d feature tap
        return feat, torch.log_softmax(self.conv8(feat), dim=-1)
