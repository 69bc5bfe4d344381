"""Base layers in batch-last (B, N, C) layout.

Counterparts of ``imgadapointr_tpu/nn/layers.py``. Parameters carry the
reference torch state-dict names and shapes, so reference checkpoints and
:func:`tools.convert.state_dict_from_flax` load with a plain
``load_state_dict``. Dropout and stochastic depth (:class:`Dropout`,
:class:`DropPath`) have no parameters; they draw their masks from the
generator the model's forward hands them (:func:`set_dropout_generator`),
and only in train mode at a rate above 0, so a model whose rates are 0
(every shipped config) draws nothing. :class:`LayerScale` exists only
where ``init_values`` is set.
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
    contracted before it is broadcast. ``kernel_dims`` as for
    :class:`Linear` (a reference 1x1 Conv1d over the concat: 1)."""

    def __init__(self, widths, out_features: int, bias: bool = True, kernel_dims: int = 0):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, sum(self.widths), *([1] * kernel_dims)))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        if len(parts) != len(self.widths):
            raise ValueError(f"ConcatDense expects {len(self.widths)} parts, got {len(parts)}")
        weight = self.weight.reshape(self.out_features, sum(self.widths))
        out, start = None, 0
        for i, (p, w) in enumerate(zip(parts, self.widths)):
            y = F.linear(p, weight[:, start : start + w], self.bias if i == 0 else None)
            out = y if out is None else out + y
            start += w
        return out


def keep_mask(shape, keep: float, generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """A boolean mask of ``shape``, each entry True with probability
    ``keep``: a float32 uniform draw from ``generator`` (on ``device``)
    below ``keep``, as ``jax.random.bernoulli`` draws. The explicit
    generator is the point: ``torch.nn.functional.dropout`` would draw from
    the global one. Raises without a generator, so no draw is hidden."""
    if generator is None:
        raise ValueError("dropout in train mode needs a generator: pass one to the model's forward")
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device) < keep


class _Stochastic(nn.Module):
    """A layer that, in train mode at a rate above 0, keeps each entry of
    its mask with probability keep = 1 - rate, drawn from the generator
    :func:`set_dropout_generator` gave it: ``where(mask, x / keep, 0)``;
    the identity otherwise. A subclass picks the mask's shape."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(keep_mask(self.mask_shape(x), keep, self.generator, x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class Dropout(_Stochastic):
    """An elementwise mask (flax ``nn.Dropout``)."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)


class DropPath(_Stochastic):
    """Stochastic depth: one mask entry per sample (the leading axis), so a
    sample keeps or drops its whole branch
    (``imgadapointr_tpu/nn/layers.py:117-131``)."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0],) + (1,) * (x.dim() - 1)


def stochastic_layers(model: nn.Module) -> tuple:
    """The model's :class:`Dropout` and :class:`DropPath` layers with a rate
    above 0, in module order."""
    return tuple(m for m in model.modules() if isinstance(m, _Stochastic) and m.rate > 0.0)


def set_dropout_generator(layers, generator: torch.Generator | None) -> None:
    """Hand ``generator`` to each layer of ``layers`` (see
    :func:`stochastic_layers`): their masks come from it in train mode."""
    for m in layers:
        m.generator = generator


class LayerScale(nn.Module):
    """Per-channel learned scale ``x * gamma``, ``gamma`` initialised to
    ``init_values`` (reference Transformer_utils.py:862-869)."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (reference
    models/Transformer_utils.py:71-87)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(gelu(self.fc1(x)))))


def _sdpa(q, k, v, scale: float, mask: torch.Tensor | None = None,
          dropout: nn.Module | None = None) -> torch.Tensor:
    """Attention on (B, H, N, D) tensors with the softmax in >= float32.
    Written as matmul + softmax, as the JAX package leaves it to XLA.
    ``mask`` is boolean, broadcastable to (B, H, N, M), True = masked;
    ``dropout`` applies to the attention weights."""
    acc = torch.promote_types(q.dtype, torch.float32)
    attn = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * scale
    if mask is not None:
        attn = attn.masked_fill(mask, torch.finfo(attn.dtype).min)
    attn = attn.softmax(dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn.to(v.dtype), v)


class Attention(nn.Module):
    """Multi-head self-attention (reference Transformer_utils.py:89-122)
    with an optional boolean mask, True = masked: the denoise task's rule
    that real queries do not see the denoise tokens. ``attn_drop`` drops
    attention weights, ``proj_drop`` the output."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = _sdpa(qkv[0], qkv[1], qkv[2], self.scale, mask, self.attn_drop)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(B, N, C)))


class CrossAttention(nn.Module):
    """Multi-head cross-attention, q from queries, k and v from memory
    (reference Transformer_utils.py:124-159; the blocks use out_dim == dim),
    with the dropouts of :class:`Attention`."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q_map = Linear(dim, dim, bias=qkv_bias)
        self.k_map = Linear(dim, dim, bias=qkv_bias)
        self.v_map = Linear(dim, dim, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, N, C = q.shape
        M = v.shape[1]
        H = self.num_heads

        def heads(t, n):
            return t.reshape(B, n, H, C // H).transpose(1, 2)

        out = _sdpa(heads(self.q_map(q), N), heads(self.k_map(v), M),
                    heads(self.v_map(v), M), self.scale, dropout=self.attn_drop)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(B, N, C)))


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
    >= float32, as ``imgadapointr_tpu/nn/layers.py:255-276`` takes them,
    but the variance in two passes, ``E[(x - E[x])^2]`` (torch's own
    BatchNorm does likewise), where the JAX package takes ``E[x^2] -
    E[x]^2``: a channel whose mean is 130 times its spread (FoldingNet's
    folds, a global feature added to every point) loses four digits to that
    cancellation in float32. Biased for the normalisation, unbiased for the
    running update. Buffers match ``torch.nn.BatchNorm1d`` for state-dict
    loading."""

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
            var = (xs - mean).square().mean(dim=axes)
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
    draws them (Kaiming normal, fan out; biases zero); norms keep their own
    values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, ConcatDense)):
                trunc_normal_flax_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                trunc_normal_flax_(m.in_proj_weight, 0.02, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model
