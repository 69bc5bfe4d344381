"""Cross-modal fusion stacks: image or segmentation features into the
point tokens.

Counterpart of ``imgadapointr_tpu/models/fusion.py:22-81`` (reference
``models/internal/pctransformer.py:114-199``): a projection of the other
modality's features (Linear then exact GELU), then five post-LN residual
attention layers, cross(x, mem) -> self(x) -> [skip] -> cross(x, mem) ->
self(x) -> cross(x, skip), each a :class:`MultiheadAttention` with 8 heads
and LayerNorm eps 1e-5. The JAX package's ``ImgFusion`` and ``SegFusion``
are this stack with the tags "img" (over the ResNet18 trunk's
:func:`image_tokens_width` positions) and "seg" (over GDANet's
:data:`SEG_FEATURES` features).

The reference keeps these layers on its PCTransformer itself, so its
checkpoints name them ``base_model.cross_attn_img1``,
``base_model.layer_norm_seg5``, ``base_model.get_better_img_size.0`` and so
on. :class:`AttentionFusion` registers its layers on the module that owns
it under exactly those names and is itself no ``nn.Module``: the port's
state dict then has the reference's keys, and a reference checkpoint loads
with a plain ``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Linear, MultiheadAttention

SEG_FEATURES = 128  # width of GDANet's feature tap


class AttentionFusion:
    """The fusion stack ``tag`` ("img" or "seg") of width ``dim`` over
    ``feat_dim``-wide features, its layers registered on ``owner``."""

    def __init__(self, owner: nn.Module, tag: str, dim: int, feat_dim: int, num_heads: int = 8):
        def add(name: str, module: nn.Module) -> nn.Module:
            owner.add_module(name, module)
            return module

        self.proj = add(f"get_better_{tag}_size", nn.Sequential(Linear(feat_dim, dim), nn.GELU()))
        self.cross = [add(f"cross_attn_{tag}{i}", MultiheadAttention(dim, num_heads)) for i in (1, 2, 3)]
        self.self_attn = [add(f"self_attn_{tag}{i}", MultiheadAttention(dim, num_heads)) for i in (1, 2)]
        self.norms = [add(f"layer_norm_{tag}{i}", nn.LayerNorm(dim, eps=1e-5)) for i in range(1, 6)]

    def __call__(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """x (B, n, dim) tokens, feat (B, m, feat_dim) -> (B, n, dim)."""
        mem = self.proj(feat)
        ln1, ln2, ln3, ln4, ln5 = self.norms
        x = ln1(self.cross[0](x, mem) + x)
        x = ln2(self.self_attn[0](x, x) + x)
        skip = x
        x = ln3(self.cross[1](x, mem) + x)
        x = ln4(self.self_attn[1](x, x) + x)
        return ln5(self.cross[2](x, skip) + x)


def image_tokens_width(img_size: int) -> int:
    """Spatial positions of the ResNet18 trunk's output (each stride-2 stage
    maps h to (h - 1) // 2 + 1): 196 at 224², the reference's
    ``Linear(196, 384)``."""
    h = img_size
    for _ in range(4):  # stem conv, max pool, layer2, layer3
        h = (h - 1) // 2 + 1
    return h * h
