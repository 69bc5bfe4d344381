"""The image branch's encoder: torchvision's ResNet18 through ``layer3``.

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
"""

from __future__ import annotations

import torch
from torch import nn


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock``: two 3x3 convolutions with BatchNorm,
    a 1x1 projection on the shortcut where the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                                            nn.BatchNorm2d(cout))

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
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), nn.BatchNorm2d(64),
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
