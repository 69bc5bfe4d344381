"""ImgAdaPoinTr: AdaPoinTr with ResNet18 image features fused into the
encoder tokens (registry name ``ImgResNetEncAdaPoinTrVariableLoss``),
trained with the variable coarse loss.

Counterpart of ``imgadapointr_tpu/models/img_adapointr.py:32-64``
(reference ``models/internal/ImgResNetEncAdaPoinTrVariableLoss.py``). The
reference sets its flags by mutating the config inside the class; here the
registry builder sets them on a copy.
"""

from __future__ import annotations

import torch

from ..utils import trace
from ..utils.config import AttrDict
from ..utils.registry import MODELS
from .adapointr import AdaPoinTr, place


def branch_config(config, use_img: bool, use_seg: bool, seg_before_enc: bool = False,
                  seg_before_dec: bool = False) -> AttrDict:
    """A copy of ``config`` with the branch flags set."""
    cfg = AttrDict(config)
    cfg.use_img_features, cfg.use_seg_features = use_img, use_seg
    cfg.seg_before_enc, cfg.seg_before_dec = seg_before_enc, seg_before_dec
    return cfg


class ImgAdaPoinTr(AdaPoinTr):
    """(partial (B, N, 3), img (B, H, W, 3)) -> AdaPoinTr's return."""

    inputs = ("partial", "img")
    variable_loss = True

    def forward(self, xyz: torch.Tensor, img: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """``bn_momentum``, ``generator`` and ``noise`` as in
        :meth:`AdaPoinTr.forward`; the momentum reaches the ResNet too."""
        with trace.span("branch.image_encoder"):
            img_feat = self.base_model.im_encoder(img, bn_momentum)
        return super().forward(xyz, bn_momentum=bn_momentum, generator=generator, noise=noise,
                               img_feat=img_feat)


@MODELS.register_module(name="ImgResNetEncAdaPoinTrVariableLoss")
def build_img_adapointr(config, device="cuda", seed: int = 0,
                        dtype: torch.dtype = torch.float32) -> ImgAdaPoinTr:
    return place(ImgAdaPoinTr(branch_config(config, use_img=True, use_seg=False)),
                 device, seed, dtype)
