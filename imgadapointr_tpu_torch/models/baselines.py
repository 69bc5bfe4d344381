"""The classic completion baselines: FoldingNet, PCN and TopNet.

Counterpart of ``imgadapointr_tpu/models/baselines.py:22-209`` (reference
``models/external/{FoldingNet,PCN,TopNet}.py``). All three share the PCN
PointNet encoder (conv, BN, ReLU, conv, max, concat, conv, BN, ReLU, conv,
max) and train with CD-L2 on (coarse, fine). Eval and train return the
same pair: FoldingNet and TopNet their fine cloud twice, PCN (coarse,
fine). Every layer is batch-last; the parameters are named after the flax
tree (``tools/convert.py``: the JAX package pins no reference names for
these models). No kernel runs in their forward passes; the loss's chamfer
does (``ops/chamfer.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, ConcatDense, Linear
from ..ops import chamfer_l2
from ..utils.registry import MODELS
from .adapointr import place


def grid_seed(grid_size: int, half: float) -> torch.Tensor:
    """(grid², 2) float32 grid over [-half, half]², the first coordinate
    fastest (``_grid_seed``)."""
    lin = np.linspace(-half, half, grid_size, dtype=np.float32)
    a = np.broadcast_to(lin[None, :], (grid_size, grid_size)).reshape(-1)
    b = np.broadcast_to(lin[:, None], (grid_size, grid_size)).reshape(-1)
    return torch.from_numpy(np.stack([a, b], axis=-1))


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """The BN-momentum schedule's value into every BatchNorm of ``model``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = momentum


BASELINES: dict[str, type] = {}  # name: class of the five baselines


def register_baseline(cls):
    """Class decorator: ``cls`` into :data:`BASELINES` and its builder
    ``(config, device, seed, dtype)`` into ``MODELS``, both under its name."""
    BASELINES[cls.__name__] = cls
    MODELS.register_module(name=cls.__name__)(
        lambda config, device="cuda", seed=0, dtype=torch.float32: place(cls(config), device, seed, dtype))
    return cls


class Baseline(nn.Module):
    """What the runner asks of a model: ``inputs``, ``forward(xyz,
    bn_momentum, generator, noise)`` and ``loss(ret, gt, epoch_f)``; the
    loss of the three PCN baselines and GRNet is CD-L2 on both clouds."""

    inputs = ("partial",)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        set_bn_momentum(self, bn_momentum)
        return self.complete(xyz)

    def loss(self, ret, gt: torch.Tensor, epoch_f: float):
        return chamfer_l2(ret[0], gt), chamfer_l2(ret[1], gt)


class PCNFeatureEncoder(nn.Module):
    """(B, N, 3) -> (B, out_channel) (reference FoldingNet.py:14-27)."""

    def __init__(self, out_channel: int):
        super().__init__()
        self.first_conv1 = Linear(3, 128)
        self.first_bn = BatchNorm(128)
        self.first_conv2 = Linear(128, 256)
        self.second_conv1 = ConcatDense((256, 256), 512)
        self.second_bn = BatchNorm(512)
        self.second_conv2 = Linear(512, out_channel)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        f = self.first_conv2(F.relu(self.first_bn(self.first_conv1(xyz))))
        g = f.amax(dim=1, keepdim=True)
        f = self.second_conv1(g, f)
        return self.second_conv2(F.relu(self.second_bn(f))).amax(dim=1)


@register_baseline
class FoldingNet(Baseline):
    """Two folds of a sqrt(num_pred) grid (reference FoldingNet.py); a fold
    is ConcatDense(512) over (points, global feature), BN, ReLU, Linear(512),
    BN, ReLU, Linear(3)."""

    def __init__(self, config):
        super().__init__()
        num_pred, enc_ch = int(config.num_pred), int(config.encoder_channel)
        self.grid_size = int(num_pred**0.5 + 0.5)
        self.encoder = PCNFeatureEncoder(enc_ch)
        for i, n_in in ((1, 2), (2, 3)):
            layers = {"conv1": ConcatDense((n_in, enc_ch), 512), "bn1": BatchNorm(512),
                      "conv2": Linear(512, 512), "bn2": BatchNorm(512), "conv3": Linear(512, 3)}
            for name, mod in layers.items():  # flax names: folding{i}_{layer}
                self.add_module(f"folding{i}_{name}", mod)

    def _fold(self, i: int, pts, feat):
        m = lambda n: getattr(self, f"folding{i}_{n}")  # noqa: E731
        h = F.relu(m("bn1")(m("conv1")(pts, feat)))
        return m("conv3")(F.relu(m("bn2")(m("conv2")(h))))

    def complete(self, xyz):
        B = xyz.shape[0]
        feat = self.encoder(xyz)[:, None, :]  # (B, 1, C): ConcatDense broadcasts it
        seed = grid_seed(self.grid_size, 0.5).to(xyz)[None].expand(B, -1, -1)
        fd2 = self._fold(2, self._fold(1, seed, feat), feat)
        return fd2, fd2  # the reference returns the last fold twice (:76)


@register_baseline
class PCN(Baseline):
    """Coarse MLP, then a 4x4 grid folding for the dense cloud (reference PCN.py)."""

    GRID_SIZE = 4

    def __init__(self, config):
        super().__init__()
        num_fine, enc_ch = int(config.num_pred), int(config.encoder_channel)
        gs = self.GRID_SIZE
        if num_fine % gs**2:
            raise ValueError(f"PCN: num_pred {num_fine} must be a multiple of {gs**2}")
        self.num_coarse = num_fine // gs**2
        self.encoder = PCNFeatureEncoder(enc_ch)
        self.mlp1 = Linear(enc_ch, 1024)
        self.mlp2 = Linear(1024, 1024)
        self.mlp3 = Linear(1024, 3 * self.num_coarse)
        self.final_conv1 = ConcatDense((enc_ch, 2, 3), 512)
        self.final_bn1 = BatchNorm(512)
        self.final_conv2 = Linear(512, 512)
        self.final_bn2 = BatchNorm(512)
        self.final_conv3 = Linear(512, 3)

    def complete(self, xyz):
        B, gs = xyz.shape[0], self.GRID_SIZE
        feat = self.encoder(xyz)
        h = F.relu(self.mlp2(F.relu(self.mlp1(feat))))
        coarse = self.mlp3(h).reshape(B, self.num_coarse, 3)
        point_feat = coarse.repeat_interleave(gs**2, dim=1)
        seed = grid_seed(gs, 0.05).to(xyz).repeat(self.num_coarse, 1)[None].expand(B, -1, -1)
        h = F.relu(self.final_bn1(self.final_conv1(feat[:, None], seed, point_feat)))
        h = F.relu(self.final_bn2(self.final_conv2(h)))
        return coarse, self.final_conv3(h) + point_feat


TREE_ARCH = {
    2: [32, 64],
    4: [4, 8, 8, 8],
    6: [2, 4, 4, 4, 4, 4],
    8: [2, 2, 2, 2, 2, 4, 4, 4],
}


def get_arch(nlevels: int, npts: int) -> list:
    """The tree's branching for npts = 2048 * 2^k points: the last smallest
    factor doubled k times (reference TopNet.py:17-25)."""
    logmult = int(math.log2(npts / 2048))
    if 2048 * 2**logmult != npts:
        raise ValueError(f"TopNet: num_pred {npts} must be 2048 * 2^n")
    arch = np.asarray(TREE_ARCH[nlevels])
    for _ in range(logmult):
        arch[np.where(arch == arch.min())[0][-1]] *= 2
    return [int(x) for x in arch]


@register_baseline
class TopNet(Baseline):
    """Hierarchical tree decoder (reference TopNet.py:29-109)."""

    def __init__(self, config):
        super().__init__()
        self.node_feature = nf = int(config.node_feature)
        # the reference reads encoder_feature; its shipped config gives encoder_channel
        self.enc = enc = int(config.get("encoder_feature", config.get("encoder_channel", 1024)))
        self.nlevels = int(config.nlevels)
        self.tarch = get_arch(self.nlevels, int(config.num_pred))
        self.encoder = PCNFeatureEncoder(enc)
        self.root_fc1 = Linear(enc, 256)
        self.root_bn1 = BatchNorm(256)
        self.root_fc2 = Linear(256, 64)
        self.root_bn2 = BatchNorm(64)
        self.root_fc3 = Linear(64, nf * self.tarch[0])
        in_ch = enc + nf
        for i in range(1, self.nlevels):
            name, out = ("leaf", 3) if i == self.nlevels - 1 else (f"level{i}", nf)
            layers = {"c1": ConcatDense((enc, nf), in_ch // 2), "bn1": BatchNorm(in_ch // 2),
                      "c2": Linear(in_ch // 2, in_ch // 4), "bn2": BatchNorm(in_ch // 4),
                      "c3": Linear(in_ch // 4, in_ch // 8), "bn3": BatchNorm(in_ch // 8),
                      "c4": Linear(in_ch // 8, out * self.tarch[i])}
            for lname, mod in layers.items():
                self.add_module(f"{name}_{lname}", mod)

    def complete(self, xyz):
        B = xyz.shape[0]
        feat = self.encoder(xyz)
        h = F.relu(self.root_bn1(self.root_fc1(feat)))
        h = F.relu(self.root_bn2(self.root_fc2(h)))
        level = torch.tanh(self.root_fc3(h)).reshape(B, self.tarch[0], self.node_feature)
        for i in range(1, self.nlevels):
            name, out = ("leaf", 3) if i == self.nlevels - 1 else (f"level{i}", self.node_feature)
            m = lambda n: getattr(self, f"{name}_{n}")  # noqa: E731
            h = F.relu(m("bn1")(m("c1")(feat[:, None], level)))
            h = F.relu(m("bn2")(m("c2")(h)))
            h = m("c4")(F.relu(m("bn3")(m("c3")(h))))
            level = torch.tanh(h.reshape(B, level.shape[1] * self.tarch[i], out))
        return level, level

