"""Point rebuild heads (counterpart of ``imgadapointr_tpu/nn/heads.py``).

- ``SimpleRebuildFCLayer``: the flagship's ``decoder_type: fc`` head;
- ``Fold``: ``decoder_type: fold``, the FoldingNet head (reference
  base_blocks.py:702-744): a step x step grid over [-1, 1]² folded twice,
  each fold a 1x1-conv stack (``folding1`` / ``folding2``: conv, BN, ReLU,
  conv, BN, ReLU, conv) over cat(seed, token feature). The grid is a
  constant buffer on the model's device, not in the state dict.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm, ConcatDense, Linear, gelu


def folding_seed(step: int) -> torch.Tensor:
    """(step², 2) grid over [-1, 1]², the first coordinate fastest
    (reference base_blocks.py:709-711)."""
    lin = np.linspace(-1.0, 1.0, step, dtype=np.float32)
    a = np.broadcast_to(lin[None, :], (step, step)).reshape(-1)
    b = np.broadcast_to(lin[:, None], (step, step)).reshape(-1)
    return torch.from_numpy(np.stack([a, b], axis=-1))


def _fold_stack(seed_dim: int, in_channel: int, hidden: int) -> nn.Sequential:
    # reference Sequential(Conv1d(seed + C, h, 1), BN, ReLU, Conv1d(h, h/2, 1), BN, ReLU, Conv1d(h/2, 3, 1))
    return nn.Sequential(
        ConcatDense((seed_dim, in_channel), hidden, kernel_dims=1), BatchNorm(hidden), nn.ReLU(),
        Linear(hidden, hidden // 2, kernel_dims=1), BatchNorm(hidden // 2), nn.ReLU(),
        Linear(hidden // 2, 3, kernel_dims=1),
    )


class Fold(nn.Module):
    """Token features (B*, C) -> (B*, step², 3) offsets. The token's
    feature enters each fold's first layer as one (B*, 1, hidden) product
    broadcast over the step² seed rows, whose own product is taken once."""

    def __init__(self, in_channel: int, step: int, hidden_dim: int = 512):
        super().__init__()
        self.step = step
        self.register_buffer("seed", folding_seed(step), persistent=False)
        self.folding1 = _fold_stack(2, in_channel, hidden_dim)
        self.folding2 = _fold_stack(3, in_channel, hidden_dim)

    @staticmethod
    def _fold(stack: nn.Sequential, seed: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        return stack[1:](stack[0](seed, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = x[:, None, :]  # (B*, 1, C)
        fd1 = self._fold(self.folding1, self.seed.to(x.dtype), features)  # (B*, step², 3)
        return self._fold(self.folding2, fd1, features)


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
