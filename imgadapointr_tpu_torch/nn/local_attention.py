"""Local attention of the block tokens (counterpart of
``imgadapointr_tpu/nn/local_attention.py``).

- ``DynamicGraphAttention``: 'graph', the edge conv over the kNN graph;
- ``DeformableLocalAttention``: 'rw_deform', a deformable gather then k x k
  self-attention over the region and a max over it;
- ``DeformableLocalCrossAttention``: 'deform', a deformable gather then 1 x k
  attention of each token over its region, as self- or cross-attention;
- ``ImprovedDeformableLocalGraphAttention``: 'deform_graph', a deformable
  gather with offsets scaled by the region's box, then an edge conv;

each with the two-phase neighbour search of the denoise task where the JAX
package has it. The deformable gather predicts 3-D offsets of the
neighbour positions and re-samples the values there by inverse-distance
3-NN interpolation (:func:`ops.three_nn_interpolate_grouped`, kernel
``csrc/three_nn_interpolate.cu``). Parameters carry the reference names
(``proj_q``, ``proj_k``, ``proj_v``, ``proj_v_off``, ``linear_offset.{0,1,3}``,
``proj`` or ``knn_map.0``). ``ImprovedDeformableLocalCrossAttention``
(no block token builds it) is 'deform' with the box-scaled offsets of
'deform_graph', at any ``n_group``. The three modules with an output
projection drop it at ``proj_drop`` in train mode, as the JAX package's
three ``nn.Dropout`` sites do; their ``attn_drop`` is unused there too.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import index_points, knn_point, three_nn_interpolate_grouped
from .layers import Dropout, Linear, leaky_relu


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


def offset_net(in_dim: int, dim: int) -> nn.Sequential:
    """Learned 3-D offsets: Linear -> LayerNorm(eps 1e-5) -> GELU ->
    Linear(3, no bias) -> tanh (``linear_offset.{0,1,3}``)."""
    return nn.Sequential(Linear(in_dim, dim), nn.LayerNorm(dim, eps=1e-5), nn.GELU(),
                         Linear(dim, 3, bias=False), nn.Tanh())


def grouped_deform_gather(offsets: nn.Module, q_proj, v, v_off_local, local_v_pos, v_pos,
                          n_group: int, scale_by_bbox: bool = False) -> torch.Tensor:
    """The deformable core (``imgadapointr_tpu/nn/local_attention.py:49-88``):
    per channel group, offsets from the gathered offset features and the
    query, the neighbour positions shifted by them (by half the region's
    box extent with ``scale_by_bbox``), and the values ``v`` (B, M, C)
    re-sampled there by 3-NN interpolation over ``v_pos`` (B, M, 3).
    Returns (B, N, k, C).

    One call of :func:`ops.three_nn_interpolate_grouped` does every group:
    it adds the offsets to the positions, reads ``v_pos`` and each group's
    channels of ``v`` in place and writes (B, N k, C) in this order, where
    the JAX package copies the positions and values into group-major order
    and the result back. The shifted positions are detached: interpolation
    has no gradient in its positions (pointnet2's ``three_nn``), so
    ``linear_offset`` and ``proj_v_off`` get none, as in the JAX package,
    and their ``grad`` stays None."""
    B, N, k, C = v_off_local.shape
    g = n_group
    cg = C // g
    off_local_v = v_off_local.reshape(B, N, k, g, cg).permute(0, 3, 1, 2, 4)  # b g n k c
    group_q = q_proj.reshape(B, N, g, cg).permute(0, 2, 1, 3)  # b g n c
    shift_feat = torch.cat([off_local_v, group_q[:, :, :, None].expand(B, g, N, k, cg)], dim=-1)
    offset = offsets(shift_feat)  # (B, g, N, k, 3)
    if scale_by_bbox:
        extent = local_v_pos.amax(dim=-2) - local_v_pos.amin(dim=-2)  # (B, N, 3)
        offset = offset * (0.5 * extent[:, None, :, None, :])
    interp = three_nn_interpolate_grouped(local_v_pos.reshape(B, N * k, 3),
                                          offset.reshape(B, g, N * k, 3), v_pos, v)
    return interp.reshape(B, N, k, C)


def local_cross_attn(q_proj, k_feat, v_feat, num_heads: int, scale: float) -> torch.Tensor:
    """1 x k attention of each token (B, N, C) over its region (B, N, k, C)."""
    B, N, k, C = k_feat.shape
    D = C // num_heads
    qh = q_proj.reshape(B, N, num_heads, D)
    kh = k_feat.reshape(B, N, k, num_heads, D)
    vh = v_feat.reshape(B, N, k, num_heads, D)
    attn = (torch.einsum("bnhd,bnkhd->bnhk", qh, kh) * scale).softmax(dim=-1)
    return torch.einsum("bnhk,bnkhd->bnhd", attn, vh).reshape(B, N, C)


class _DeformableAttention(nn.Module):
    """The parameters of 'rw_deform' and 'deform': the q / k / v and offset
    feature projections, the grouped offset net and the output projection
    (then its dropout)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 k: int = 10, n_group: int = 2, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.k, self.n_group = num_heads, k, n_group
        self.scale = (dim // num_heads) ** -0.5
        self.proj_q = Linear(dim, dim, bias=qkv_bias)
        self.proj_k = Linear(dim, dim, bias=qkv_bias)
        self.proj_v = Linear(dim, dim, bias=qkv_bias)
        self.proj_v_off = Linear(dim, dim, bias=qkv_bias)
        self.linear_offset = offset_net(2 * dim // n_group, dim)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)


class DeformableLocalAttention(_DeformableAttention):
    """'rw_deform': deformable gather -> k x k region self-attention -> max
    over the region (``imgadapointr_tpu/nn/local_attention.py:125-172``)."""

    def forward(self, x, pos, idx=None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        if idx is None:
            idx = knn_point(self.k, pos, pos)
        q = self.proj_q(x)
        local_v = index_points(self.proj_v_off(x), idx)
        local_v_pos = index_points(pos, idx)
        interp = grouped_deform_gather(self.linear_offset, q, x, local_v, local_v_pos, pos,
                                       self.n_group)
        k = idx.shape[-1]
        qh = index_points(q, idx).reshape(B, N, k, H, C // H)
        kh = self.proj_k(interp).reshape(B, N, k, H, C // H)
        vh = self.proj_v(interp).reshape(B, N, k, H, C // H)
        attn = (torch.einsum("bnkhd,bnlhd->bnhkl", qh, kh) * self.scale).softmax(dim=-1)
        out = torch.einsum("bnhkl,bnlhd->bnkhd", attn, vh).reshape(B, N, k, C)
        return self.proj_drop(self.proj(out.amax(dim=2)))


class DeformableLocalCrossAttention(_DeformableAttention):
    """'deform': deformable gather -> 1 x k attention of each token over its
    region; self-attention (v = q), cross-attention, or the self-attention
    of the denoise task with its two-phase search
    (``imgadapointr_tpu/nn/local_attention.py:175-232``)."""

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None,
                denoise_length: int = 0) -> torch.Tensor:
        if denoise_length == 0:
            v = q if v is None else v
            v_pos = q_pos if v_pos is None else v_pos
            if idx is None:
                idx = knn_point(self.k, v_pos, q_pos)
            qp = self.proj_q(q)
            v_off = self.proj_v_off(v)
            local_v, local_v_pos = index_points(v_off, idx), index_points(v_pos, idx)
        else:
            if v is not None or v_pos is not None or idx is not None:
                raise ValueError("DeformableLocalCrossAttention: denoise mode is self-attention only")
            v, v_pos = q, q_pos
            qp = self.proj_q(q)
            v_off = self.proj_v_off(v)
            local_v, local_v_pos = two_phase_knn_gather(self.k, q_pos, v_pos, (v_off, v_pos),
                                                        denoise_length)
        return self._attend(qp, v, local_v, local_v_pos, v_pos)

    def _attend(self, qp, v, local_v, local_v_pos, v_pos, scale_by_bbox: bool = False):
        interp = grouped_deform_gather(self.linear_offset, qp, v, local_v, local_v_pos, v_pos,
                                       self.n_group, scale_by_bbox)
        out = local_cross_attn(qp, self.proj_k(interp), self.proj_v(interp), self.num_heads,
                               self.scale)
        return self.proj_drop(self.proj(out))


class ImprovedDeformableLocalCrossAttention(DeformableLocalCrossAttention):
    """'deform' with each region's offsets scaled by half its box extent,
    per channel group (``imgadapointr_tpu/nn/local_attention.py:235-273``,
    reference Transformer_utils.py:495-623): self- or cross-attention, no
    denoise mode."""

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None) -> torch.Tensor:
        v = q if v is None else v
        v_pos = q_pos if v_pos is None else v_pos
        if idx is None:
            idx = knn_point(self.k, v_pos, q_pos)
        qp = self.proj_q(q)
        v_off = self.proj_v_off(v)
        local_v, local_v_pos = index_points(v_off, idx), index_points(v_pos, idx)
        return self._attend(qp, v, local_v, local_v_pos, v_pos, scale_by_bbox=True)


class ImprovedDeformableLocalGraphAttention(nn.Module):
    """'deform_graph': an ungrouped deformable gather with offsets scaled by
    half the region's box extent, then the edge conv max_k LeakyReLU(cat(
    v_nbr - q, q) W + b) (``imgadapointr_tpu/nn/local_attention.py:276-318``).
    ``proj_v_off`` always has a bias, as in the JAX package."""

    def __init__(self, dim: int, k: int = 10):
        super().__init__()
        self.k = k
        self.proj_v_off = Linear(dim, dim)
        self.linear_offset = offset_net(2 * dim, dim)
        self.knn_map = nn.Sequential(Linear(dim * 2, dim), nn.LeakyReLU(0.2))

    def forward(self, q, q_pos, v=None, v_pos=None, idx=None,
                denoise_length: int = 0) -> torch.Tensor:
        if denoise_length == 0:
            v = q if v is None else v
            v_pos = q_pos if v_pos is None else v_pos
            if idx is None:
                idx = knn_point(self.k, v_pos, q_pos)
            v_off = self.proj_v_off(v)
            off_local_v, local_v_pos = index_points(v_off, idx), index_points(v_pos, idx)
        else:
            if v is not None or v_pos is not None or idx is not None:
                raise ValueError("ImprovedDeformableLocalGraphAttention: denoise mode is "
                                 "self-attention only")
            v, v_pos = q, q_pos
            v_off = self.proj_v_off(v)
            off_local_v, local_v_pos = two_phase_knn_gather(self.k, q_pos, v_pos, (v_off, v_pos),
                                                            denoise_length)
        interp = grouped_deform_gather(self.linear_offset, q, v, off_local_v, local_v_pos, v_pos,
                                       n_group=1, scale_by_bbox=True)
        qk = q[:, :, None].expand_as(interp)
        return self.knn_map(torch.cat([interp - qk, qk], dim=-1)).amax(dim=2)


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
            local_u = index_points(lin.project(v, w[:, :C]), idx)  # v W1 + b
        else:
            if v is not None or v_pos is not None or idx is not None:
                raise ValueError("DynamicGraphAttention: denoise mode is self-attention only")
            u = lin.project(q, w[:, :C])
            (local_u,) = two_phase_knn_gather(self.k, q_pos, q_pos, (u,), denoise_length)
        c = lin.project(q, w[:, C:] - w[:, :C], bias=False)  # q (W2 - W1)
        out = leaky_relu(local_u + c[:, :, None])
        return out.amax(dim=2)


def make_local_attn(token: str, dim: int, num_heads: int, qkv_bias: bool, k: int,
                    n_group: int, drop: float = 0.0) -> nn.Module:
    """The module of a local block token, ``drop`` its output dropout
    (``imgadapointr_tpu/nn/blocks.py:36-51``)."""
    if token == "rw_deform":
        return DeformableLocalAttention(dim, num_heads, qkv_bias, k, n_group, drop)
    if token == "deform":
        return DeformableLocalCrossAttention(dim, num_heads, qkv_bias, k, n_group, drop)
    if token == "graph":
        return DynamicGraphAttention(dim, k)
    if token == "deform_graph":
        return ImprovedDeformableLocalGraphAttention(dim, k)
    raise ValueError(f"unexpected block token {token!r}")
