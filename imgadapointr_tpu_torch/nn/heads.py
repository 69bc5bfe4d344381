"""Point rebuild heads (counterpart of ``imgadapointr_tpu/nn/heads.py``).

Only ``SimpleRebuildFCLayer``, the flagship's ``decoder_type: fc`` head;
the folding head waits for a config that uses it.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConcatDense, Linear, gelu


class _RebuildMlp(nn.Module):
    """The reference head's Mlp over cat(global, token): ``fc1`` is one
    Linear on the concat, kept as a :class:`ConcatDense`."""

    def __init__(self, input_dims: int, hidden_dim: int, out_dim: int):
        super().__init__()
        half = input_dims // 2
        self.fc1 = ConcatDense((half, input_dims - half), hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim)

    def forward(self, g, x):
        return self.fc2(gelu(self.fc1(g, x)))


class SimpleRebuildFCLayer(nn.Module):
    """cat(global max, token) -> Mlp -> step * 3 offsets.
    Input (B, N, C); output (B, N, step, 3)."""

    def __init__(self, input_dims: int, step: int, hidden_dim: int = 512):
        super().__init__()
        self.step = step
        self.layer = _RebuildMlp(input_dims, hidden_dim, step * 3)

    def forward(self, rec_feature: torch.Tensor) -> torch.Tensor:
        B, N, _ = rec_feature.shape
        g = rec_feature.amax(dim=1, keepdim=True)
        return self.layer(g, rec_feature).reshape(B, N, self.step, 3)
