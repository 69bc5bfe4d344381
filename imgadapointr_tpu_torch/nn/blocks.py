"""Config-driven encoder/decoder transformer stacks.

Counterpart of ``imgadapointr_tpu/nn/blocks.py`` for every block token
(``attn`` and the local tokens ``graph``, ``rw_deform``, ``deform`` and
``deform_graph``, alone or as ``attn-<local>``) with ``combine_style:
concat``, with the denoise mask of the training forward. The 'onebyone'
combine style, LayerScale, dropout and stochastic depth come with the
configs that need them. Module names follow the reference state dict
(``encoder.blocks.blocks.{i}``, ``decoder.blocks.blocks.{i}``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import knn_point
from .layers import Attention, CrossAttention, Linear, Mlp
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


def _check_combine(style: str) -> None:
    if style != "concat":
        raise NotImplementedError(
            f"combine_style {style!r}: only 'concat' (the shipped configs') is ported"
        )


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


class SelfAttnBlockApi(nn.Module):
    """Encoder block: global attention and/or local attention, then MLP;
    every local token takes the same (x, pos, idx) call."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 block_style="attn-graph", combine_style="concat", k=10, n_group=2):
        super().__init__()
        _check_combine(combine_style)
        has_attn, local = _parse_style(block_style)
        self.norm1 = _norm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias) if has_attn else None
        self.local_attn = (make_local_attn(local, dim, num_heads, qkv_bias, k, n_group)
                           if local else None)
        self.merge_map = Linear(dim * 2, dim) if has_attn and local else None
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, pos, idx=None):
        nx = self.norm1(x)
        if self.merge_map is not None:
            f = self.merge_map(torch.cat([self.attn(nx), self.local_attn(nx, pos, idx=idx)], -1))
        elif self.attn is not None:
            f = self.attn(nx)
        else:
            f = self.local_attn(nx, pos, idx=idx)
        x = x + f
        return x + self.mlp(self.norm2(x))


class CrossAttnBlockApi(nn.Module):
    """Decoder block: a self-attention half and a cross-attention half,
    each global and/or local, then MLP. A 'rw_deform' self half is called
    without ``denoise_length``: in the denoise task it searches its own
    neighbours over all tokens (imgadapointr_tpu/nn/blocks.py:222-228)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 self_attn_block_style="attn-graph", self_attn_combine_style="concat",
                 cross_attn_block_style="attn-graph", cross_attn_combine_style="concat",
                 k=10, n_group=2):
        super().__init__()
        _check_combine(self_attn_combine_style)
        _check_combine(cross_attn_combine_style)
        sa_attn, sa_local = _parse_style(self_attn_block_style)
        ca_attn, ca_local = _parse_style(cross_attn_block_style, _CROSS_LOCAL_TOKENS)
        self.self_local_token = sa_local
        self.norm1 = _norm(dim)
        self.self_attn = Attention(dim, num_heads, qkv_bias) if sa_attn else None
        self.local_self_attn = (make_local_attn(sa_local, dim, num_heads, qkv_bias, k, n_group)
                                if sa_local else None)
        self.self_attn_merge_map = Linear(dim * 2, dim) if sa_attn and sa_local else None
        self.norm_q = _norm(dim)
        self.norm_v = _norm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias) if ca_attn else None
        self.local_cross_attn = (make_local_attn(ca_local, dim, num_heads, qkv_bias, k, n_group)
                                 if ca_local else None)
        self.cross_attn_merge_map = Linear(dim * 2, dim) if ca_attn and ca_local else None
        self.norm2 = _norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, q, v, q_pos, v_pos, self_attn_idx=None, cross_attn_idx=None,
                denoise_length: int = 0):
        mask = denoise_mask(q.shape[1], denoise_length, q.device)
        nq = self.norm1(q)

        def local_self():
            if self.self_local_token == "rw_deform":
                return self.local_self_attn(nq, q_pos, idx=self_attn_idx)
            return self.local_self_attn(nq, q_pos, idx=self_attn_idx,
                                        denoise_length=denoise_length)

        if self.self_attn_merge_map is not None:
            f = self.self_attn_merge_map(torch.cat([self.self_attn(nq, mask), local_self()], -1))
        elif self.self_attn is not None:
            f = self.self_attn(nq, mask)
        else:
            f = local_self()
        q = q + f

        nq, nv = self.norm_q(q), self.norm_v(v)

        def local_cross():
            return self.local_cross_attn(nq, q_pos, v=nv, v_pos=v_pos, idx=cross_attn_idx)

        if self.cross_attn_merge_map is not None:
            f = self.cross_attn_merge_map(torch.cat([self.cross_attn(nq, nv), local_cross()], -1))
        elif self.cross_attn is not None:
            f = self.cross_attn(nq, nv)
        else:
            f = local_cross()
        q = q + f
        return q + self.mlp(self.norm2(q))


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
                 qkv_bias=True, block_style_list=("attn-graph",),
                 combine_style="concat", k=10, n_group=2):
        super().__init__()
        if len(block_style_list) != depth:
            raise ValueError("block_style_list must have depth entries")
        self.k = k
        self.blocks = _Stack([
            SelfAttnBlockApi(embed_dim, num_heads, mlp_ratio, qkv_bias,
                             block_style_list[i], combine_style, k, n_group)
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
                 qkv_bias=True, self_attn_block_style_list=("attn-graph",),
                 self_attn_combine_style="concat",
                 cross_attn_block_style_list=("attn-graph",),
                 cross_attn_combine_style="concat", k=10, n_group=2):
        super().__init__()
        if not len(self_attn_block_style_list) == len(cross_attn_block_style_list) == depth:
            raise ValueError("block style lists must have depth entries")
        self.k = k
        self.blocks = _Stack([
            CrossAttnBlockApi(embed_dim, num_heads, mlp_ratio, qkv_bias,
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
    if cfg.get("init_values", None) is not None:
        raise NotImplementedError("LayerScale (init_values) is not ported: no shipped config sets it")
    for rate in ("drop_rate", "attn_drop_rate", "drop_path_rate"):
        if float(cfg.get(rate, 0.0)) != 0.0:
            raise NotImplementedError(
                f"{rate} = {cfg[rate]}: dropout and stochastic depth are not ported "
                "(every shipped AdaPoinTr config sets 0)"
            )
    return dict(
        embed_dim=int(cfg.embed_dim), depth=int(cfg.depth), num_heads=int(cfg.num_heads),
        mlp_ratio=float(cfg.get("mlp_ratio", 4.0)), qkv_bias=bool(cfg.get("qkv_bias", True)),
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
