"""Base layers in batch-last (B, N, C) layout.

Counterparts of ``imgadapointr_tpu/nn/layers.py``. Parameters carry the
reference torch state-dict names and shapes, so reference checkpoints and
:func:`tools.convert.state_dict_from_flax` load with a plain
``load_state_dict``. Dropout and stochastic depth have no parameters and
their rates are 0 in every shipped AdaPoinTr config, so they are not
instantiated (the blocks raise on a non-zero rate); LayerScale appears
only with ``init_values``, which no shipped config sets (the blocks raise
on it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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


def _sdpa(q, k, v, scale: float, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention on (B, H, N, D) tensors with the softmax in >= float32.
    Written as matmul + softmax, as the JAX package leaves it to XLA.
    ``mask`` is boolean, broadcastable to (B, H, N, M), True = masked."""
    acc = torch.promote_types(q.dtype, torch.float32)
    attn = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * scale
    if mask is not None:
        attn = attn.masked_fill(mask, torch.finfo(attn.dtype).min)
    attn = attn.softmax(dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


class Attention(nn.Module):
    """Multi-head self-attention (reference Transformer_utils.py:89-122)
    with an optional boolean mask, True = masked: the denoise task's rule
    that real queries do not see the denoise tokens."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = _sdpa(qkv[0], qkv[1], qkv[2], self.scale, mask)
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


class MultiheadAttention(nn.Module):
    """The parameters of ``torch.nn.MultiheadAttention(dim, num_heads)``
    (``in_proj_weight`` packing the q, k and v projections by rows,
    ``in_proj_bias``, ``out_proj``), computed with the port's own matmul and
    softmax (:func:`_sdpa`) so that no fused attention path chooses the
    numerics. ``forward(x, mem)`` attends from ``x`` to ``mem``; self
    attention is ``forward(x, x)``. Counterpart of the JAX package's
    ``CrossAttention`` / ``Attention`` with ``qkv_bias=True``, the form its
    fusion stacks use (``imgadapointr_tpu/models/fusion.py:22-47``)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        M, H = mem.shape[1], self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(t, i, n):
            t = F.linear(t, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return t.reshape(B, n, H, C // H).transpose(1, 2)

        out = _sdpa(heads(x, 0, N), heads(mem, 1, M), heads(mem, 2, M), self.scale)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, eps 1e-5, with torch-style momentum
    read at call time from ``self.momentum`` (the BN-momentum schedule sets
    it before each step): ``running = (1 - m) * running + m * batch``.

    In train mode the batch statistics are taken over every other axis in
    >= float32, as ``imgadapointr_tpu/nn/layers.py:255-276`` takes them: the
    variance is ``E[x^2] - E[x]^2``, biased for the normalisation and
    unbiased for the running update. Buffers match ``torch.nn.BatchNorm1d``
    for state-dict loading."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xs.mean(dim=axes)
            var = xs.square().mean(dim=axes) - mean.square()
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = float(self.momentum)
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
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
    """Seeded init, every weight drawn in module order from ``generator``:
    Linear, ConcatDense and the attention projections flax-style (truncated
    normal, std 0.02, biases zero), convolutions as torchvision's ResNet
    draws them (Kaiming normal, fan out); norms keep their own values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, ConcatDense)):
                trunc_normal_flax_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                trunc_normal_flax_(m.in_proj_weight, 0.02, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)
    return model
