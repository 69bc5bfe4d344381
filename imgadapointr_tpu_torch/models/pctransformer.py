"""PCTransformer, the AdaPoinTr encoder/decoder core, point branch.

Counterpart of ``imgadapointr_tpu/models/pctransformer.py:32-153``:
grouper (DGCNN for ``encoder_type: graph``, the per-group PointNet of
``nn/grouper.py:SimpleEncoder`` for ``pn``) -> positional embedding +
input projection -> encoder -> global feature -> coarse prediction + FPS
query candidates -> query ranking (top num_query) -> mlp_query -> decoder. In train mode ``DENOISE_LENGTH``
jittered FPS points of the input are appended to the ranked queries as
denoise queries.

The image and segmentation branches (``:76-151`` there) are switched on by
the config's flags, which the registry builders of ``models/img_adapointr.py``
and ``models/seg_adapointr.py`` set: the image fusion after the encoder
(``use_img_features``, unless ``img_before_dec``), and one segmentation
fusion shared by the encoder tokens (``seg_before_enc``, GDANet on the
centres) and the decoder queries (``seg_before_dec``, GDANet on the
non-denoise queries). The ResNet18 trunk (``im_encoder``) and the frozen
GDANet (``segmentator``) live here, where the reference keeps them, so the
state dict has the reference's keys; the model wrapper runs them and
passes ``img_feat`` and ``seg_fn`` in. The config's ``img_size`` (default
224, the reference's) sets the image projection's width: the trunk's
spatial positions, 196 at 224².
"""

from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..nn.blocks import decoder_from_config, encoder_from_config
from ..nn.grouper import DGCNNGrouper, SimpleEncoder
from ..nn.image_encoders import ResNet18Encoder
from ..nn.layers import ConcatDense, Linear
from ..parallel.dist import global_draw
from ..utils import trace
from .fusion import SEG_FEATURES, AttentionFusion, image_tokens_width
from .gdanet import GDANet


DENOISE_LENGTH = 64  # reference AdaPoinTr.py:126-129


def _mlp2(a: int, b: int, c: int) -> nn.Sequential:
    # reference Sequential(Linear, GELU, Linear): state-dict keys .0 and .2
    return nn.Sequential(Linear(a, b), nn.GELU(), Linear(b, c))


class PCTransformer(nn.Module):
    def __init__(self, config):
        super().__init__()
        if config.encoder_type not in ("graph", "pn"):
            raise ValueError(f"encoder_type {config.encoder_type!r}: 'graph' or 'pn'")
        enc, dec = config.encoder_config, config.decoder_config
        C, D = int(enc.embed_dim), int(dec.embed_dim)
        gfd = int(config.global_feature_dim)
        self.center_num = tuple(int(n) for n in config.get("center_num", (512, 128)))
        self.num_query = int(config.num_query)

        self.grouper = (DGCNNGrouper(k=16) if config.encoder_type == "graph"
                        else SimpleEncoder(k=32, embed_dims=512))
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

        self.img_fusion = self.seg_fusion = None
        if config.get("use_img_features", False):
            self.im_encoder = ResNet18Encoder()
            if not config.get("img_before_dec", False):
                width = image_tokens_width(int(config.get("img_size", 224)))
                self.img_fusion = AttentionFusion(self, "img", C, width)
        self.seg_before_enc = self.seg_before_dec = False
        if config.get("use_seg_features", False):
            self.segmentator = GDANet(50).requires_grad_(False)  # frozen
            self.seg_fusion = AttentionFusion(self, "seg", C, SEG_FEATURES)
            self.seg_before_enc = bool(config.get("seg_before_enc", False))
            self.seg_before_dec = bool(config.get("seg_before_dec", False))

    def forward(self, xyz: torch.Tensor, img_feat: torch.Tensor | None = None,
                seg_fn=None, cls_vec: torch.Tensor | None = None,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """(q, coarse, denoise_length). ``img_feat`` (B, 256, positions) are
        the image tokens, ``seg_fn(points, cls_vec)`` gives GDANet's
        (B, n, 128) features of n points; each is needed only when its
        branch is on. ``generator`` draws the denoise jitter in train mode,
        before anything else draws; ``noise`` (B, DENOISE_LENGTH, 3),
        standard normal, replaces the draw."""
        B = xyz.shape[0]
        if self.training and noise is None:
            # the denoise jitter's draw comes first, then any dropout masks
            # in module order (jitter_points would draw the same tensor)
            noise = global_draw(torch.randn, (B, DENOISE_LENGTH, 3), generator=generator, dtype=xyz.dtype,
                                device=xyz.device)
        with trace.span("model.grouper"):
            coor, f = self.grouper(xyz, self.center_num)
        with trace.span("model.encoder"):
            x = self.encoder(self.input_proj(f) + self.pos_embed(coor), coor)
        if self.img_fusion is not None:
            with trace.span("branch.img_fusion"):
                x = self.img_fusion(x, img_feat)
        if self.seg_before_enc:
            with trace.span("branch.gdanet"):
                seg = seg_fn(coor, cls_vec)
            with trace.span("branch.seg_fusion"):
                x = self.seg_fusion(x, seg)

        with trace.span("model.query"):
            global_feature = self.increase_dim(x).amax(dim=1)  # (B, gfd)
            coarse = self.coarse_pred(global_feature).reshape(B, self.num_query, 3)
            coarse = torch.cat([coarse, ops.fps(xyz, self.num_query // 2)], dim=1)
            mem = x if self.mem_link is None else self.mem_link(x)

            # top num_query by ranking score, in jax.lax.top_k's order:
            # descending, ties to the lower index (a stable ascending sort of -r).
            # Only the indices are used, so query_ranking gets no gradient and
            # its parameters keep grad None (the reference's zero-grad subtree).
            r = self.query_ranking(coarse)[..., 0]
            idx = torch.sort(-r, dim=-1, stable=True).indices[:, : self.num_query]
            coarse = ops.index_points(coarse, idx)

            denoise_length = 0
            if self.training:
                denoise_length = DENOISE_LENGTH
                picked = ops.jitter_points(ops.fps(xyz, denoise_length), generator, noise=noise)
                coarse = torch.cat([coarse, picked], dim=1)

            q = self.mlp_query[0](global_feature[:, None, :], coarse)
            q = self.mlp_query[1:](q)
        with trace.span("model.decoder"):
            q = self.decoder(q, mem, coarse, coor, denoise_length=denoise_length)
        if self.seg_before_dec:  # on the non-denoise queries only
            n_real = q.shape[1] - denoise_length
            with trace.span("branch.gdanet"):
                seg = seg_fn(coarse[:, :n_real], cls_vec)
            with trace.span("branch.seg_fusion"):
                q_real = self.seg_fusion(q[:, :n_real], seg)
            q = torch.cat([q_real, q[:, n_real:]], dim=1) if denoise_length else q_real
        return q, coarse, denoise_length
