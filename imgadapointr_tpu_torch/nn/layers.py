"""Base layers in batch-last (B, N, C) layout, eval forms.

Counterparts of ``imgadapointr_tpu/nn/layers.py``. Parameters carry the
reference torch state-dict names and shapes, so reference checkpoints and
:func:`tools.convert.state_dict_from_flax` load with a plain
``load_state_dict``. Dropout and stochastic depth are identities in eval
and have no parameters, so they are not instantiated; LayerScale appears
only with ``init_values``, which no shipped config sets (the blocks raise
on it). Training-mode forms (batch statistics, denoise masks) belong to the
training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_TRAINING_SLICE = "training-mode forward is part of the training slice (ROADMAP Queue 1)"


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's and the JAX package's default."""
    return F.gelu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


@torch.no_grad()
def trunc_normal_flax_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax ``truncated_normal(stddev=std, lower=-2, upper=2)``: a standard
    normal truncated to [-2, 2], rescaled so the result has std ``std``."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    w.copy_(x.clamp_(-2.0, 2.0) * (std / 0.87962566103423978))


class Linear(nn.Module):
    """``y = x Wᵀ + b`` with the flax init (truncated normal, std 0.02, zero
    bias; see :func:`init_weights_`). ``kernel_dims`` appends 1-dims to the
    weight, the layout of a reference 1x1 Conv1d (1) or Conv2d (2)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 kernel_dims: int = 0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, *([1] * kernel_dims)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.reshape(self.out_features, self.in_features), self.bias)


class ConcatDense(nn.Module):
    """One reference ``Linear`` over ``cat(parts, -1)``, computed as per-part
    products summed: ``ConcatDense(w)(a, b) == Linear(cat([a, b], -1))``,
    with the weight split by rows of ``widths``. A part with a broadcast
    dim (a (B, 1, C) global feature against (B, M, C) tokens) is
    contracted before it is broadcast."""

    def __init__(self, widths, out_features: int, bias: bool = True):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.weight = nn.Parameter(torch.empty(out_features, sum(self.widths)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        if len(parts) != len(self.widths):
            raise ValueError(f"ConcatDense expects {len(self.widths)} parts, got {len(parts)}")
        out, start = None, 0
        for i, (p, w) in enumerate(zip(parts, self.widths)):
            y = F.linear(p, self.weight[:, start : start + w], self.bias if i == 0 else None)
            out = y if out is None else out + y
            start += w
        return out


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (reference models/Transformer_utils.py:71-87)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def _sdpa(q, k, v, scale: float) -> torch.Tensor:
    """Attention on (B, H, N, D) tensors with the softmax in >= float32.
    Written as matmul + softmax, as the JAX package leaves it to XLA."""
    acc = torch.promote_types(q.dtype, torch.float32)
    attn = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * scale
    attn = attn.softmax(dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


class Attention(nn.Module):
    """Multi-head self-attention (reference Transformer_utils.py:89-122)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = _sdpa(qkv[0], qkv[1], qkv[2], self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    """Multi-head cross-attention, q from queries, k and v from memory
    (reference Transformer_utils.py:124-159; the blocks use out_dim == dim)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q_map = Linear(dim, dim, bias=qkv_bias)
        self.k_map = Linear(dim, dim, bias=qkv_bias)
        self.v_map = Linear(dim, dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, N, C = q.shape
        M = v.shape[1]
        H = self.num_heads

        def heads(t, n):
            return t.reshape(B, n, H, C // H).transpose(1, 2)

        out = _sdpa(heads(self.q_map(q), N), heads(self.k_map(v), M),
                    heads(self.v_map(v), M), self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, eval form: running statistics, eps
    1e-5. Buffers match ``torch.nn.BatchNorm1d`` for state-dict loading."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(f"BatchNorm: {_TRAINING_SLICE}")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class GroupNorm(nn.Module):
    """GroupNorm over a channels-last (B, ..., C) tensor: statistics per
    sample and group over every non-batch axis (flax ``nn.GroupNorm``, torch
    ``nn.GroupNorm`` on channels-first)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xg = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded flax-style init: every Linear / ConcatDense weight drawn in
    module order from ``generator``, biases zero; norms keep ones/zeros."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, ConcatDense)):
                trunc_normal_flax_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model
