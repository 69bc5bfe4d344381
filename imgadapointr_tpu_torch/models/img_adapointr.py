"""ImgAdaPoinTr: AdaPoinTr with ResNet18 image features fused into the
encoder tokens (registry name ``ImgResNetEncAdaPoinTrVariableLoss``).

Counterpart of ``imgadapointr_tpu/models/img_adapointr.py:32-64``
(reference ``models/internal/ImgResNetEncAdaPoinTrVariableLoss.py``). The
reference sets its flags by mutating the config inside the class; here the
registry builder sets them on a copy. Eval only in the port so far: the
variable coarse-loss weight and the training path come with the
superset's training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from ..utils.config import AttrDict
from ..utils.registry import MODELS
from .adapointr import AdaPoinTr, place

TRAINING_NOT_PORTED = (
    "training of the image and segmentation models is not ported yet: it comes with "
    "the superset's training slice (ROADMAP Queue 1: the superset training slice)"
)


def branch_config(config, use_img: bool, use_seg: bool, seg_before_enc: bool = False,
                  seg_before_dec: bool = False) -> AttrDict:
    """A copy of ``config`` with the branch flags set."""
    cfg = AttrDict(config)
    cfg.use_img_features, cfg.use_seg_features = use_img, use_seg
    cfg.seg_before_enc, cfg.seg_before_dec = seg_before_enc, seg_before_dec
    return cfg


class ImgAdaPoinTr(AdaPoinTr):
    """(partial (B, N, 3), img (B, H, W, 3)) -> (coarse, fine), eval only."""

    inputs = ("partial", "img")

    def forward(self, xyz: torch.Tensor, img: torch.Tensor, **train_args):
        """``train_args`` are AdaPoinTr's train-mode arguments
        (``bn_momentum``, ``generator``, ``noise``); train mode raises."""
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        return super().forward(xyz, img_feat=self.base_model.im_encoder(img))


@MODELS.register_module(name="ImgResNetEncAdaPoinTrVariableLoss")
def build_img_adapointr(config, device="cuda", seed: int = 0,
                        dtype: torch.dtype = torch.float32) -> ImgAdaPoinTr:
    return place(ImgAdaPoinTr(branch_config(config, use_img=True, use_seg=False)),
                 device, seed, dtype)
