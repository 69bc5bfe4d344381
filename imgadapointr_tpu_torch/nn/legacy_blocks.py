"""The fixed-style legacy encoder and decoder blocks.

Counterpart of ``imgadapointr_tpu/nn/legacy_blocks.py`` (reference
models/Transformer_utils.py:873-1045): no config builds them, they are part
of the reference's public surface. Each is a pre-LayerNorm residual pair
(attention branch, then MLP branch), every LayerNorm at eps 1e-5 (the
configurable blocks take 1e-6), each branch ending in LayerScale (with
``init_values``) and DropPath. Parameters are named after the flax tree:
``norm1``, the attention module (``attn``, ``deformable_attn``,
``graphattn``; ``self_attn`` and ``attn`` in the decoder blocks, behind
``norm_q`` / ``norm_v``), ``norm2``, ``mlp``, ``ls_<branch>.gamma``
(``nn.blocks.add_branches`` with the branch ids ``_attn``, ``_self``,
``_cross``, ``_mlp``).
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import add_branches, branch
from .layers import Attention, CrossAttention, Mlp
from .local_attention import (DeformableLocalAttention, DeformableLocalCrossAttention,
                              DynamicGraphAttention)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


class _ResidualPair(nn.Module):
    """The shared skeleton: the attention branches ``branches`` (ids such as
    ``"_attn"``), then the MLP branch (``"_mlp"``)."""

    def __init__(self, dim: int, mlp_ratio: float, drop: float, init_values, drop_path: float,
                 branches: tuple):
        super().__init__()
        add_branches(self, dim, init_values, drop_path, branches + ("_mlp",))
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)

    def mlp_branch(self, x: torch.Tensor) -> torch.Tensor:
        return x + branch(self, "_mlp", self.mlp(self.norm2(x)))


class Block(_ResidualPair):
    """Plain self-attention block (reference :873-894)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, mlp_ratio, drop, init_values, drop_path, ("_attn",))
        self.norm1 = _ln(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)

    def forward(self, x, pos):
        x = x + branch(self, "_attn", self.attn(self.norm1(x)))
        return self.mlp_branch(x)


class RegionWiseBlock(_ResidualPair):
    """Deformable region-wise (max over the region) block (reference :896-917)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, mlp_ratio, drop, init_values, drop_path, ("_attn",))
        self.norm1 = _ln(dim)
        self.deformable_attn = DeformableLocalAttention(dim, num_heads, qkv_bias)

    def forward(self, x, pos):
        x = x + branch(self, "_attn", self.deformable_attn(self.norm1(x), pos))
        return self.mlp_branch(x)


class DeformableAttnBlock(_ResidualPair):
    """Deformable 1 x k attention block (reference :919-940)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, mlp_ratio, drop, init_values, drop_path, ("_attn",))
        self.norm1 = _ln(dim)
        self.deformable_attn = DeformableLocalCrossAttention(dim, num_heads, qkv_bias)

    def forward(self, x, pos):
        x = x + branch(self, "_attn", self.deformable_attn(self.norm1(x), pos))
        return self.mlp_branch(x)


class GraphConvBlock(_ResidualPair):
    """Edge-conv block (reference :942-959)."""

    def __init__(self, dim, mlp_ratio=4.0, drop=0.0, init_values=None, drop_path=0.0):
        super().__init__(dim, mlp_ratio, drop, init_values, drop_path, ("_attn",))
        self.norm1 = _ln(dim)
        self.graphattn = DynamicGraphAttention(dim)

    def forward(self, x, pos):
        x = x + branch(self, "_attn", self.graphattn(self.norm1(x), pos))
        return self.mlp_branch(x)


class _DecoderPair(_ResidualPair):
    """Self attention (``self_attn`` behind ``norm1``), then the block's
    cross module (``attn`` behind ``norm_q`` / ``norm_v``), then the MLP."""

    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, drop, init_values, drop_path):
        super().__init__(dim, mlp_ratio, drop, init_values, drop_path, ("_self", "_cross"))
        self.norm1 = _ln(dim)
        self.self_attn = Attention(dim, num_heads, qkv_bias)
        self.norm_q = _ln(dim)
        self.norm_v = _ln(dim)

    def cross(self, nq, nv, q_pos, v_pos):
        raise NotImplementedError

    def forward(self, q, v, q_pos, v_pos):
        q = q + branch(self, "_self", self.self_attn(self.norm1(q)))
        q = q + branch(self, "_cross", self.cross(self.norm_q(q), self.norm_v(v), q_pos, v_pos))
        return self.mlp_branch(q)


class DecoderBlock(_DecoderPair):
    """self-attention -> cross-attention -> MLP (reference :961-988)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, num_heads, mlp_ratio, qkv_bias, drop, init_values, drop_path)
        self.attn = CrossAttention(dim, num_heads, qkv_bias)

    def cross(self, nq, nv, q_pos, v_pos):
        return self.attn(nq, nv)


class DeformableAttnDecoderBlock(_DecoderPair):
    """self-attention -> deformable cross-attention -> MLP (reference :990-1017)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, num_heads, mlp_ratio, qkv_bias, drop, init_values, drop_path)
        self.attn = DeformableLocalCrossAttention(dim, num_heads, qkv_bias)

    def cross(self, nq, nv, q_pos, v_pos):
        return self.attn(nq, q_pos, v=nv, v_pos=v_pos)


class GraphConvDecoderBlock(_DecoderPair):
    """self-attention -> edge-conv cross block -> MLP (reference :1019-1045)."""

    def __init__(self, dim, num_heads=8, mlp_ratio=4.0, qkv_bias=False, drop=0.0, init_values=None,
                 drop_path=0.0):
        super().__init__(dim, num_heads, mlp_ratio, qkv_bias, drop, init_values, drop_path)
        self.attn = DynamicGraphAttention(dim)

    def cross(self, nq, nv, q_pos, v_pos):
        return self.attn(nq, q_pos, v=nv, v_pos=v_pos)


LEGACY_BLOCKS = (Block, RegionWiseBlock, DeformableAttnBlock, GraphConvBlock, DecoderBlock,
                 DeformableAttnDecoderBlock, GraphConvDecoderBlock)
