"""AdaPoinTr, the flagship completion model, eval form.

Counterpart of ``imgadapointr_tpu/models/adapointr.py:35-116`` for
``decoder_type: fc``: PCTransformer core, ``increase_dim`` (1x1 conv -> BN
-> LeakyReLU -> 1x1 conv, then a max), ``reduce_map`` over cat(global,
token, coarse), the FC rebuild head, and ``rebuild_points + coarse``.
Returns ``(coarse (B, num_query, 3), fine (B, num_points, 3))``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.heads import SimpleRebuildFCLayer
from ..nn.layers import BatchNorm, ConcatDense, Linear, init_weights_
from ..utils.device import resolve_device
from ..utils.registry import MODELS
from .pctransformer import PCTransformer


def rebuild_factor(config) -> int:
    """Points rebuilt per query token (reference AdaPoinTr.py:170-180)."""
    num_points = config.get("num_points", None)
    if num_points is None:
        return 64
    if num_points % config.num_query:
        raise ValueError("num_points must be a multiple of num_query")
    return num_points // config.num_query


class AdaPoinTr(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.decoder_type != "fc":
            raise NotImplementedError(
                f"decoder_type {config.decoder_type!r}: only 'fc' (the flagship's) is ported"
            )
        trans_dim = int(config.decoder_config.embed_dim)
        self.base_model = PCTransformer(config)
        # reference Sequential(Conv1d(C, 1024, 1), BatchNorm1d(1024), LeakyReLU(0.2), Conv1d(1024, 1024, 1))
        self.increase_dim = nn.Sequential(
            Linear(trans_dim, 1024, kernel_dims=1), BatchNorm(1024), nn.LeakyReLU(0.2),
            Linear(1024, 1024, kernel_dims=1),
        )
        self.reduce_map = ConcatDense((1024, trans_dim, 3), trans_dim)
        self.decode_head = SimpleRebuildFCLayer(trans_dim * 2, step=rebuild_factor(config))

    def forward(self, xyz: torch.Tensor):
        if self.training:
            raise NotImplementedError(
                "AdaPoinTr training forward is part of the training slice (ROADMAP Queue 1)"
            )
        q, coarse = self.base_model(xyz)
        B, M, _ = q.shape
        global_feature = self.increase_dim(q).amax(dim=1)  # (B, 1024)
        rf = self.reduce_map(global_feature[:, None], q, coarse)
        rebuild = self.decode_head(rf) + coarse[:, :, None]  # (B, M, S, 3)
        return coarse, rebuild.reshape(B, -1, 3)


@MODELS.register_module(name="AdaPoinTr")
def build_adapointr(config, device="cuda", seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> AdaPoinTr:
    """AdaPoinTr in eval mode on ``device``, weights from a seeded flax-style
    init (load a checkpoint over them with ``load_state_dict``)."""
    dev = resolve_device(device)
    model = AdaPoinTr(config)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


def build_model(config, device="cuda", seed: int = 0, dtype: torch.dtype = torch.float32):
    """Build ``config.NAME`` from the port's registry."""
    return MODELS.build(config, device=device, seed=seed, dtype=dtype)
