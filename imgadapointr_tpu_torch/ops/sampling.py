"""Stochastic point-cloud ops used inside the model's training forward.

Counterpart of ``imgadapointr_tpu/ops/sampling.py:15-27``. Randomness comes
from an explicit ``torch.Generator`` on the tensor's device, never from the
global state. The crop and dropping augmentations of that module serve the
ShapeNet-55 and KITTI recipes and wait for them (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch


def jitter_points(pc: torch.Tensor, generator: torch.Generator | None = None,
                  std: float = 0.01, clip: float = 0.05,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """``pc + clamp(std * n, -clip, clip)`` with ``n`` standard normal, drawn
    per element from ``generator``; a caller that must fix the draw (a
    comparison of two devices or two frameworks) passes ``noise``, a tensor
    of ``pc``'s shape, instead."""
    if noise is None:
        noise = torch.randn(pc.shape, generator=generator, dtype=pc.dtype, device=pc.device)
    elif noise.shape != pc.shape:
        raise ValueError(f"jitter_points: noise {tuple(noise.shape)} for points {tuple(pc.shape)}")
    return pc + (std * noise.to(device=pc.device, dtype=pc.dtype)).clamp(-clip, clip)
