"""PCTransformer, the AdaPoinTr encoder/decoder core, eval form, point branch.

Counterpart of ``imgadapointr_tpu/models/pctransformer.py:32-153``:
grouper -> positional embedding + input projection -> encoder -> global
feature -> coarse prediction + FPS query candidates -> query ranking
(top num_query) -> mlp_query -> decoder. The denoise queries (train) and
the image / segmentation fusions wait for later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..nn.blocks import decoder_from_config, encoder_from_config
from ..nn.grouper import DGCNNGrouper
from ..nn.layers import ConcatDense, Linear


def _mlp2(a: int, b: int, c: int) -> nn.Sequential:
    # reference Sequential(Linear, GELU, Linear): state-dict keys .0 and .2
    return nn.Sequential(Linear(a, b), nn.GELU(), Linear(b, c))


class PCTransformer(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.get("use_img_features", False) or config.get("use_seg_features", False):
            raise NotImplementedError(
                "image / segmentation branches wait (ROADMAP Queue 1)"
            )
        if config.encoder_type != "graph":
            raise NotImplementedError(f"encoder_type {config.encoder_type!r}: only 'graph' is ported")
        enc, dec = config.encoder_config, config.decoder_config
        C, D = int(enc.embed_dim), int(dec.embed_dim)
        gfd = int(config.global_feature_dim)
        self.center_num = tuple(int(n) for n in config.get("center_num", (512, 128)))
        self.num_query = int(config.num_query)

        self.grouper = DGCNNGrouper(k=16)
        self.pos_embed = _mlp2(3, 128, C)
        self.input_proj = _mlp2(self.grouper.num_features, 512, C)
        self.encoder = encoder_from_config(enc)
        self.increase_dim = _mlp2(C, 1024, gfd)
        self.coarse_pred = _mlp2(gfd, 1024, 3 * self.num_query)
        self.mem_link = Linear(C, D) if C != D else None
        # reference Sequential(Linear(gfd + 3, 1024), GELU, Linear, GELU, Linear)
        self.mlp_query = nn.Sequential(
            ConcatDense((gfd, 3), 1024), nn.GELU(), Linear(1024, 1024), nn.GELU(),
            Linear(1024, D),
        )
        self.query_ranking = nn.Sequential(
            Linear(3, 256), nn.GELU(), Linear(256, 256), nn.GELU(), Linear(256, 1),
            nn.Sigmoid(),
        )
        self.decoder = decoder_from_config(dec)

    def forward(self, xyz: torch.Tensor):
        B = xyz.shape[0]
        coor, f = self.grouper(xyz, self.center_num)
        x = self.encoder(self.input_proj(f) + self.pos_embed(coor), coor)

        global_feature = self.increase_dim(x).amax(dim=1)  # (B, gfd)
        coarse = self.coarse_pred(global_feature).reshape(B, self.num_query, 3)
        coarse = torch.cat([coarse, ops.fps(xyz, self.num_query // 2)], dim=1)
        mem = x if self.mem_link is None else self.mem_link(x)

        # top num_query by ranking score, in jax.lax.top_k's order:
        # descending, ties to the lower index (a stable ascending sort of -r)
        r = self.query_ranking(coarse)[..., 0]
        idx = torch.sort(-r, dim=-1, stable=True).indices[:, : self.num_query]
        coarse = ops.index_points(coarse, idx)

        q = self.mlp_query[0](global_feature[:, None, :], coarse)
        q = self.mlp_query[1:](q)
        q = self.decoder(q, mem, coarse, coor)
        return q, coarse
