"""The image encoders: torchvision's ResNet18 through ``layer3`` (the image
branch's), ResNet50 and ConvNeXt-small.

Counterpart of ``imgadapointr_tpu/nn/image_encoders.py:26-103``
(``ResNet18Encoder``; reference ``models/image_encoders.py:16-37``): the
trunk ``Sequential(children()[:-3])`` of a ResNet18 built with
``pretrained=False``, so the reference's keys are ``im_encoder.base.0``
(stem conv), ``.1`` (stem BN), ``.4.*``, ``.5.*``, ``.6.*`` (layer1-3).
The input is NHWC ``(B, H, W, 3)``, as the JAX package and the synthetic
data give it; the output ``(B, 256, H/16 * W/16)`` makes the 256 channels
the fusion's tokens, each with its spatial positions as features (196 at
224²). The convolutions are cuDNN's, in full float32 on the card
(``utils/device.py`` switches TF32 off): the JAX package computes them
outside any Pallas kernel too. In train mode every BatchNorm takes the
call's scheduled momentum, as the JAX trunk passes ``bn_momentum`` to each
(``imgadapointr_tpu/nn/image_encoders.py:31-44,78-88``).

``ResNet50Encoder`` (``imgadapointr_tpu/nn/image_encoders.py:106-115``,
reference image_encoders.py:40-49): the whole bottleneck trunk (3, 4, 6, 3
blocks; torchvision's names, ``base.0`` .. ``base.7``), a global mean and
(B, 2048) -> (B, 8, 256). ``ConvNextEncoder`` (``:118-149``): ConvNeXt-small
(depths (3, 3, 27, 3), widths (96, 192, 384, 768)), a 4x4 stride-4 stem,
2x2 stride-2 downsamples, each behind a LayerNorm (eps 1e-6), blocks of a
depthwise 7x7 convolution, LayerNorm, 4x MLP with exact GELU and ``gamma``
(initialised to 1e-6); (B, H/32 * W/32, 768) tokens; parameters named after
the flax tree (``stem``, ``stem_norm``, ``down_norm{s}``, ``down{s}``,
``stage{s}_block{b}.{dwconv,norm,pw1,pw2,gamma}``). flax's default
``'SAME'`` padding of its strided convolutions is spelt out
(:func:`same_pad`): none where the size divides by the stride, as at 224².
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import data_group
from .layers import Linear, global_moments


class BatchNorm2d(nn.BatchNorm2d):
    """``torch.nn.BatchNorm2d`` (its state-dict names, cuDNN on one rank)
    that, in train mode inside a data-parallel step over more than one rank
    (``parallel/dist.py:data_parallel``), normalises by the global batch's
    moments, taken in two passes over (N, H, W) (``nn/layers.py:global_moments``),
    and updates its running statistics from them as torch does (unbiased
    variance, the ``momentum`` of the call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = data_group() if self.training else None
        if group is None:
            return super().forward(x)
        mean, var, n = global_moments(x, (0, 2, 3), group)
        with torch.no_grad():
            m = float(self.momentum)
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
            self.num_batches_tracked += 1
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock``: two 3x3 convolutions with BatchNorm,
    a 1x1 projection on the shortcut where the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                                            BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + shortcut)


def _layer(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(cin, cout, stride), BasicBlock(cout, cout))


class ResNet18Encoder(nn.Module):
    """(B, H, W, 3) images -> (B, 256, positions) fusion tokens."""

    def __init__(self):
        super().__init__()
        self.base = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1),
            _layer(64, 64, 1), _layer(64, 128, 2), _layer(128, 256, 2),
        )

    def forward(self, img: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        """``bn_momentum``: the torch-style BatchNorm momentum of this call
        (the BN-momentum schedule's value), read in train mode only."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = bn_momentum
        x = self.base(img.permute(0, 3, 1, 2))  # (B, 256, H', W')
        return x.flatten(2)


def _set_bn_momentum(module: nn.Module, momentum: float) -> None:
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = momentum


class Bottleneck(nn.Module):
    """torchvision's ``Bottleneck``: 1x1, 3x3 (with the stride), 1x1 to 4x
    the width, each with BatchNorm; a 1x1 projection on the shortcut where
    the shape changes."""

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                                            BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + shortcut)


def _bottleneck_layer(cin: int, width: int, blocks: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Bottleneck(cin, width, stride),
                         *[Bottleneck(width * 4, width) for _ in range(blocks - 1)])


class ResNet50Encoder(nn.Module):
    """(B, H, W, 3) images -> (B, 8, 256): the global mean of the trunk's
    2048 channels, read as 8 tokens of 256."""

    def __init__(self):
        super().__init__()
        self.base = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1),
            _bottleneck_layer(64, 64, 3, 1), _bottleneck_layer(256, 128, 4, 2),
            _bottleneck_layer(512, 256, 6, 2), _bottleneck_layer(1024, 512, 3, 2),
        )

    def forward(self, img: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        _set_bn_momentum(self, bn_momentum)
        x = self.base(img.permute(0, 3, 1, 2)).mean(dim=(2, 3))  # (B, 2048)
        return x.reshape(x.shape[0], 8, 256)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``x`` (B, C, H, W) zero-padded as flax's ``'SAME'`` pads a
    convolution of this kernel and stride: ceil(n / stride) outputs, the
    padding split low = total // 2, high = the rest."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class _ChannelsLastNorm(nn.LayerNorm):
    """LayerNorm over the channels of a (B, C, H, W) map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNextBlock(nn.Module):
    """x + gamma * pw2(GELU(pw1(LayerNorm(dwconv7x7(x)))))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pw1 = Linear(dim, 4 * dim)
        self.pw2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.gamma * self.pw2(F.gelu(self.pw1(y)))
        return x + y.permute(0, 3, 1, 2)


class ConvNextEncoder(nn.Module):
    """(B, H, W, 3) images -> (B, H/32 * W/32, dims[-1]) spatial tokens."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.stem = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = _ChannelsLastNorm(dims[0], eps=1e-6)
        for s, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            if s > 0:
                self.add_module(f"down_norm{s}", _ChannelsLastNorm(self.dims[s - 1], eps=1e-6))
                self.add_module(f"down{s}", nn.Conv2d(self.dims[s - 1], dim, 2, stride=2))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", ConvNextBlock(dim))

    def forward(self, img: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        """``bn_momentum`` is unused (no BatchNorm), taken for the encoders' common call."""
        x = self.stem_norm(self.stem(same_pad(img.permute(0, 3, 1, 2), 4, 4)))
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"down{s}")(same_pad(getattr(self, f"down_norm{s}")(x), 2, 2))
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
        return x.flatten(2).transpose(1, 2)
