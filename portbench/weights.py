"""The weights of a run, made on the device from the seed in one draw.

One standard normal of the model's whole parameter count, from a
``torch.Generator`` on the card, is cut into the leaves of the reference
model (built on the meta device, so its module types say what each leaf
is) and scaled by the leaf's kind: norm scales 1 + 0.1 z, norm shifts and
biases 0.02 z, linear and attention weights z / sqrt(fan in) (LeCun: every
layer's output keeps its input's scale, so scores such as the query
ranking's spread as a trained model's do, instead of the near-ties of
std-0.02 weights), convolutions sqrt(2 / fan out) z (He, as torchvision
draws them).
Both sides get the same tensors: the program's parameters are copied from
them, and the reference's are drawn again from the same seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .reference import models, nets

NORMS = (nn.LayerNorm, nn.BatchNorm2d, models.BatchNorm, models.GroupNorm)


def _scales(reference: nn.Module) -> list:
    """(name, shape, scale, shift) of every parameter, in module order."""
    out = []
    for mname, module in reference.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(module, NORMS):
                scale, shift = (0.1, 1.0) if pname == "weight" else (0.02, 0.0)
            elif isinstance(module, nn.Conv2d):
                scale, shift = math.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3])), 0.0
            elif p.dim() >= 2:
                scale, shift = 1.0 / math.sqrt(math.prod(p.shape[1:])), 0.0
            else:
                scale, shift = 0.02, 0.0
            out.append((name, tuple(p.shape), scale, shift))
    return out


def reference_skeleton(model_name: str, model_cfg: dict) -> nn.Module:
    with torch.device("meta"):
        return nets.load(model_name).build(model_cfg)


@torch.no_grad()
def make(model_name: str, model_cfg: dict, seed: int, device) -> dict:
    """{parameter name: tensor} on ``device``, from ``seed``."""
    leaves = _scales(reference_skeleton(model_name, model_cfg))
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, scale, shift in leaves:
        n = math.prod(shape)
        out[name] = z[at:at + n].view(shape).mul_(scale).add_(shift)
        at += n
    return out


@torch.no_grad()
def load(module: nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters; the names must match."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"parameter names differ: the model lacks {extra[:5]}, the weights lack {missing[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
