"""Config-driven encoder/decoder transformer stacks.

Counterpart of ``imgadapointr_tpu/nn/blocks.py`` for every block token
(``attn`` and the local tokens ``graph``, ``rw_deform``, ``deform`` and
``deform_graph``, alone or as ``attn-<local>``) in either combine style
('concat', 'onebyone'), with the denoise mask of the training forward,
LayerScale (``init_values``), dropout (``drop_rate``, ``attn_drop_rate``)
and stochastic depth (``drop_path_rate``, spread over the stack by
``linspace(0, rate, depth)``). Module names follow the reference state
dict (``encoder.blocks.blocks.{i}``, ``decoder.blocks.blocks.{i}``,
``ls{i}.gamma``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import knn_point
from .layers import Attention, CrossAttention, DropPath, LayerScale, Linear, Mlp
from .local_attention import make_local_attn

_LOCAL_TOKENS = ("rw_deform", "deform", "graph", "deform_graph")
# the cross-attention half takes no 'rw_deform' (imgadapointr_tpu/nn/blocks.py:268-270)
_CROSS_LOCAL_TOKENS = ("deform", "graph", "deform_graph")


def _parse_style(style: str, local_tokens=_LOCAL_TOKENS):
    """'attn' / '<local>' / 'attn-<local>' -> (has_attn, local token or None)."""
    tokens = style.split("-")
    if not 1 <= len(tokens) <= 2:
        raise ValueError(f"invalid block style {style!r}")
    for t in tokens:
        if t != "attn" and t not in local_tokens:
            raise ValueError(f"unexpected block token {t!r} in {style!r}")
    return "attn" in tokens, next((t for t in tokens if t != "attn"), None)


def denoise_mask(query_len: int, denoise_length: int, device=None) -> torch.Tensor | None:
    """Boolean (N, N) mask, True = masked: the real queries cannot attend
    to the trailing ``denoise_length`` denoise tokens (reference
    base_blocks.py:224-229). None when there are no denoise tokens."""
    if denoise_length == 0:
        return None
    m = torch.zeros(query_len, query_len, dtype=torch.bool, device=device)
    m[:-denoise_length, -denoise_length:] = True
    return m


def _norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def add_branches(block: nn.Module, dim: int, init_values, drop_path: float, ids) -> None:
    """The tails of ``block``'s residual branches: ``ls{i}`` (LayerScale,
    with ``init_values``) and ``drop_path{i}`` for each branch id ``i`` of
    ``ids``; :func:`branch` applies them."""
    for i in ids:
        if init_values:
            setattr(block, f"ls{i}", LayerScale(dim, init_values))
        setattr(block, f"drop_path{i}", DropPath(drop_path))


def branch(block: nn.Module, i, x):
    """Branch ``i``'s output ``x`` through its LayerScale and DropPath."""
    ls = getattr(block, f"ls{i}", None)
    return getattr(block, f"drop_path{i}")(x if ls is None else ls(x))


def _check_combine(style: str) -> None:
    if style not in ("concat", "onebyone"):
        raise ValueError(f"combine_style {style!r}: 'concat' or 'onebyone'")


class SelfAttnBlockApi(nn.Module):
    """Encoder block: global attention and/or local attention, then MLP;
    every local token takes the same (x, pos, idx) call. With both kinds,
    'concat' merges them in one branch (``merge_map``), 'onebyone' runs
    them as two residual branches, the local one behind its own ``norm3``.
    Each branch ends in LayerScale (``ls{i}``, with ``init_values``) and
    DropPath (``drop_path{i}``): 1 attention, 3 local, 2 MLP
    (``imgadapointr_tpu/nn/blocks.py:79-162``)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False, drop=0.0, attn_drop=0.0,
                 init_values=None, drop_path=0.0, block_style="attn-graph",
                 combine_style="concat", k=10, n_group=2):
        super().__init__()
        _check_combine(combine_style)
        has_attn, local = _parse_style(block_style)
        self.onebyone = has_attn and local and combine_style == "onebyone"
        self.norm1 = _norm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop) if has_attn else None
        self.local_attn = (make_local_attn(local, dim, num_heads, qkv_bias, k, n_group, drop)
                           if local else None)
        self.merge_map = Linear(dim * 2, dim) if has_attn and local and not self.onebyone else None
        self.norm3 = _norm(dim) if self.onebyone else None
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)
        add_branches(self, dim, init_values, drop_path, (1, 3, 2) if self.onebyone else (1, 2))

    def forward(self, x, pos, idx=None):
        if self.onebyone:
            x = x + branch(self, 1, self.attn(self.norm1(x)))
            x = x + branch(self, 3, self.local_attn(self.norm3(x), pos, idx=idx))
        else:
            nx = self.norm1(x)
            if self.merge_map is not None:
                f = self.merge_map(torch.cat([self.attn(nx), self.local_attn(nx, pos, idx=idx)], -1))
            elif self.attn is not None:
                f = self.attn(nx)
            else:
                f = self.local_attn(nx, pos, idx=idx)
            x = x + branch(self, 1, f)
        return x + branch(self, 2, self.mlp(self.norm2(x)))


class CrossAttnBlockApi(nn.Module):
    """Decoder block: a self-attention half and a cross-attention half,
    each global and/or local and each with its own combine style, then MLP.
    A 'rw_deform' self half is called without ``denoise_length``: in the
    denoise task it searches its own neighbours over all tokens
    (imgadapointr_tpu/nn/blocks.py:222-228). Branches: 1 self attention, 3
    local self attention ('onebyone'), 4 cross attention, 5 local cross
    attention ('onebyone', behind ``norm_q_2`` / ``norm_v_2``), 2 MLP
    (``imgadapointr_tpu/nn/blocks.py:165-345``)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False, drop=0.0, attn_drop=0.0,
                 init_values=None, drop_path=0.0,
                 self_attn_block_style="attn-graph", self_attn_combine_style="concat",
                 cross_attn_block_style="attn-graph", cross_attn_combine_style="concat",
                 k=10, n_group=2):
        super().__init__()
        _check_combine(self_attn_combine_style)
        _check_combine(cross_attn_combine_style)
        sa_attn, sa_local = _parse_style(self_attn_block_style)
        ca_attn, ca_local = _parse_style(cross_attn_block_style, _CROSS_LOCAL_TOKENS)
        self.self_onebyone = sa_attn and sa_local and self_attn_combine_style == "onebyone"
        self.cross_onebyone = ca_attn and ca_local and cross_attn_combine_style == "onebyone"
        self.self_local_token = sa_local

        def local(token):
            return make_local_attn(token, dim, num_heads, qkv_bias, k, n_group, drop) if token else None

        self.norm1 = _norm(dim)
        self.self_attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop) if sa_attn else None
        self.local_self_attn = local(sa_local)
        self.self_attn_merge_map = (Linear(dim * 2, dim) if sa_attn and sa_local
                                    and not self.self_onebyone else None)
        self.norm3 = _norm(dim) if self.self_onebyone else None
        self.norm_q = _norm(dim)
        self.norm_v = _norm(dim)
        self.cross_attn = (CrossAttention(dim, num_heads, qkv_bias, attn_drop, drop)
                           if ca_attn else None)
        self.local_cross_attn = local(ca_local)
        self.cross_attn_merge_map = (Linear(dim * 2, dim) if ca_attn and ca_local
                                     and not self.cross_onebyone else None)
        if self.cross_onebyone:
            self.norm_q_2, self.norm_v_2 = _norm(dim), _norm(dim)
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)
        ids = (1,) + ((3,) if self.self_onebyone else ()) + (4,) + ((5,) if self.cross_onebyone else ()) + (2,)
        add_branches(self, dim, init_values, drop_path, ids)

    def forward(self, q, v, q_pos, v_pos, self_attn_idx=None, cross_attn_idx=None,
                denoise_length: int = 0):
        mask = denoise_mask(q.shape[1], denoise_length, q.device)

        def local_self(nq):
            if self.self_local_token == "rw_deform":
                return self.local_self_attn(nq, q_pos, idx=self_attn_idx)
            return self.local_self_attn(nq, q_pos, idx=self_attn_idx,
                                        denoise_length=denoise_length)

        if self.self_onebyone:
            q = q + branch(self, 1, self.self_attn(self.norm1(q), mask))
            q = q + branch(self, 3, local_self(self.norm3(q)))
        else:
            nq = self.norm1(q)
            if self.self_attn_merge_map is not None:
                f = self.self_attn_merge_map(torch.cat([self.self_attn(nq, mask), local_self(nq)], -1))
            elif self.self_attn is not None:
                f = self.self_attn(nq, mask)
            else:
                f = local_self(nq)
            q = q + branch(self, 1, f)

        def local_cross(nq, nv):
            return self.local_cross_attn(nq, q_pos, v=nv, v_pos=v_pos, idx=cross_attn_idx)

        if self.cross_onebyone:
            q = q + branch(self, 4, self.cross_attn(self.norm_q(q), self.norm_v(v)))
            q = q + branch(self, 5, local_cross(self.norm_q_2(q), self.norm_v_2(v)))
        else:
            nq, nv = self.norm_q(q), self.norm_v(v)
            if self.cross_attn_merge_map is not None:
                f = self.cross_attn_merge_map(torch.cat([self.cross_attn(nq, nv), local_cross(nq, nv)], -1))
            elif self.cross_attn is not None:
                f = self.cross_attn(nq, nv)
            else:
                f = local_cross(nq, nv)
            q = q + branch(self, 4, f)
        return q + branch(self, 2, self.mlp(self.norm2(q)))


class _Stack(nn.Module):
    """Holds ``blocks`` so parameter names read ``...blocks.blocks.{i}``."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class PointTransformerEncoder(nn.Module):
    """SelfAttnBlockApi stack with one kNN index shared by every block.
    ``norm`` exists only so reference state dicts load: the reference never
    applies it (base_blocks.py:429-431), and neither does this forward."""

    def __init__(self, embed_dim=256, depth=12, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=True, init_values=None, drop_rate=0.0, attn_drop_rate=0.0,
                 drop_path_rate=0.0, block_style_list=("attn-graph",),
                 combine_style="concat", k=10, n_group=2):
        super().__init__()
        if len(block_style_list) != depth:
            raise ValueError("block_style_list must have depth entries")
        self.k = k
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = _Stack([
            SelfAttnBlockApi(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                             init_values, float(dpr[i]), block_style_list[i], combine_style, k,
                             n_group)
            for i in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x, pos):
        idx = knn_point(self.k, pos, pos)
        for blk in self.blocks.blocks:
            x = blk(x, pos, idx=idx)
        return x


class PointTransformerDecoder(nn.Module):
    """CrossAttnBlockApi stack; the self and cross kNN indices are computed
    once for the whole stack. With denoise tokens the self index is left to
    each local block's own search: two-phase for 'graph', 'deform' and
    'deform_graph', over all tokens for 'rw_deform' (reference
    base_blocks.py:337-367)."""

    def __init__(self, embed_dim=256, depth=12, num_heads=4, mlp_ratio=4.0,
                 qkv_bias=True, init_values=None, drop_rate=0.0, attn_drop_rate=0.0,
                 drop_path_rate=0.0, self_attn_block_style_list=("attn-graph",),
                 self_attn_combine_style="concat",
                 cross_attn_block_style_list=("attn-graph",),
                 cross_attn_combine_style="concat", k=10, n_group=2):
        super().__init__()
        if not len(self_attn_block_style_list) == len(cross_attn_block_style_list) == depth:
            raise ValueError("block style lists must have depth entries")
        self.k = k
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = _Stack([
            CrossAttnBlockApi(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                              init_values, float(dpr[i]),
                              self_attn_block_style_list[i], self_attn_combine_style,
                              cross_attn_block_style_list[i], cross_attn_combine_style, k,
                              n_group)
            for i in range(depth)
        ])

    def forward(self, q, v, q_pos, v_pos, denoise_length: int = 0):
        self_idx = knn_point(self.k, q_pos, q_pos) if denoise_length == 0 else None
        cross_idx = knn_point(self.k, v_pos, q_pos)
        for blk in self.blocks.blocks:
            q = blk(q, v, q_pos, v_pos, self_attn_idx=self_idx, cross_attn_idx=cross_idx,
                    denoise_length=denoise_length)
        return q


def _common(cfg) -> dict:
    return dict(
        embed_dim=int(cfg.embed_dim), depth=int(cfg.depth), num_heads=int(cfg.num_heads),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)), qkv_bias=bool(cfg.get("qkv_bias", True)),
        init_values=cfg.get("init_values", None), drop_rate=float(cfg.get("drop_rate", 0.0)),
        attn_drop_rate=float(cfg.get("attn_drop_rate", 0.0)),
        drop_path_rate=float(cfg.get("drop_path_rate", 0.0)),
        k=int(cfg.get("k", 10)), n_group=int(cfg.get("n_group", 2)),
    )


def encoder_from_config(cfg) -> PointTransformerEncoder:
    return PointTransformerEncoder(
        block_style_list=tuple(cfg.block_style_list),
        combine_style=cfg.get("combine_style", "concat"), **_common(cfg),
    )


def decoder_from_config(cfg) -> PointTransformerDecoder:
    return PointTransformerDecoder(
        self_attn_block_style_list=tuple(cfg.self_attn_block_style_list),
        self_attn_combine_style=cfg.get("self_attn_combine_style", "concat"),
        cross_attn_block_style_list=tuple(cfg.cross_attn_block_style_list),
        cross_attn_combine_style=cfg.get("cross_attn_combine_style", "concat"),
        **_common(cfg),
    )
