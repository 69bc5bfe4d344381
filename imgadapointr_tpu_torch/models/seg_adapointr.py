"""The segmentation models: frozen GDANet features fused into AdaPoinTr.

Counterpart of ``imgadapointr_tpu/models/seg_adapointr.py:33-177``:

- ``SegEncAdaPoinTr``: GDANet's features of the encoder centres fused into
  the encoder tokens (``seg_before_enc``);
- ``ImgEncSegDecAdaPoinTrVariableLoss`` (the superset): the image fused
  after the encoder, GDANet's features of the ranked queries fused into the
  decoder's output (``seg_before_dec``).

GDANet takes the points, their normals (k = 30) and the class one-hot. It
is frozen (``models/gdanet.py``); in train mode its SGCAMs take the
commuted product. With ``IMGADAPOINTR_ENABLE_SEG_REMAT`` set (opt-in, train
mode only; ``imgadapointr_tpu/models/seg_adapointr.py:64-106``) the
flow-through (normals, then GDANet) runs under
``torch.utils.checkpoint``: its activations are not kept for the backward
but recomputed there from the same points, which select the same
neighbours (every selection is deterministic on one input), so the loss
is bit-equal and the gradients agree to float32 rounding; a memory lever,
at the price of a second GDANet forward. ``SegEncAdaPoinTr`` trains with
AdaPoinTr's loss, the superset with the variable coarse loss
(``seg_adapointr.py:156``, ``:172-174`` there).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import estimate_pointcloud_normals
from ..utils import trace
from ..utils.envflags import env_flag
from ..utils.registry import MODELS
from .adapointr import AdaPoinTr, place
from .gdanet import GDANet
from .img_adapointr import branch_config


def _scrambled_normals(coor: torch.Tensor) -> torch.Tensor:
    """The normals exactly as the reference feeds them to GDANet.

    The reference passes (B, N, 3) normals to GDANet, whose
    ``local_operator_withnorm`` views them as (B, 3, N): a reinterpretation
    of the buffer, not a transpose (``seg_adapointr.py:33-48``). So the
    (B, N, 3) buffer is read as (B, 3, N) and that is transposed, which
    scrambles the channels, as the reference (and a converted reference
    checkpoint) does.
    """
    normals = estimate_pointcloud_normals(coor, 30)
    B, N, _ = normals.shape
    return normals.reshape(B, 3, N).transpose(1, 2)


def seg_features(gdanet: GDANet, coor: torch.Tensor, cls_vec: torch.Tensor,
                 commute: bool = False, remat: bool = False) -> torch.Tensor:
    """GDANet's (B, n, 128) feature tap for the points ``coor`` (B, n, 3);
    ``commute`` selects the SGCAMs' train-mode product, ``remat`` recomputes
    the pass in the backward instead of keeping its activations."""

    def body(points, cls):
        feat, _ = gdanet(points, _scrambled_normals(points), cls, commute=commute)
        return feat

    coor = coor.contiguous()
    if remat:
        return checkpoint(body, coor, cls_vec, use_reentrant=False)
    return body(coor, cls_vec)


def _seg_fn(model):
    """The model's GDANet feature function for this call's mode."""
    return functools.partial(seg_features, model.base_model.segmentator, commute=model.training,
                             remat=model.training and env_flag("IMGADAPOINTR_ENABLE_SEG_REMAT"))


class SegEncAdaPoinTr(AdaPoinTr):
    """(partial (B, N, 3), cls_vec (B, 16)) -> AdaPoinTr's return."""

    inputs = ("partial", "cls_vec")

    def forward(self, xyz: torch.Tensor, cls_vec: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """``bn_momentum``, ``generator`` and ``noise`` as in :meth:`AdaPoinTr.forward`."""
        return super().forward(xyz, bn_momentum=bn_momentum, generator=generator, noise=noise,
                               seg_fn=_seg_fn(self), cls_vec=cls_vec)


class ImgEncSegDecAdaPoinTr(AdaPoinTr):
    """(partial (B, N, 3), img (B, H, W, 3), cls_vec (B, 16)) -> AdaPoinTr's
    return."""

    inputs = ("partial", "img", "cls_vec")
    variable_loss = True

    def forward(self, xyz: torch.Tensor, img: torch.Tensor, cls_vec: torch.Tensor,
                bn_momentum: float = 0.1, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        """``bn_momentum``, ``generator`` and ``noise`` as in
        :meth:`AdaPoinTr.forward`; the momentum reaches the ResNet too."""
        with trace.span("branch.image_encoder"):
            img_feat = self.base_model.im_encoder(img, bn_momentum)
        return super().forward(xyz, bn_momentum=bn_momentum, generator=generator, noise=noise,
                               img_feat=img_feat,
                               seg_fn=_seg_fn(self), cls_vec=cls_vec)


@MODELS.register_module(name="SegEncAdaPoinTr")
def build_seg_enc(config, device="cuda", seed: int = 0,
                  dtype: torch.dtype = torch.float32) -> SegEncAdaPoinTr:
    cfg = branch_config(config, use_img=False, use_seg=True, seg_before_enc=True)
    return place(SegEncAdaPoinTr(cfg), device, seed, dtype)


@MODELS.register_module(name="ImgEncSegDecAdaPoinTrVariableLoss")
def build_img_enc_seg_dec(config, device="cuda", seed: int = 0,
                          dtype: torch.dtype = torch.float32) -> ImgEncSegDecAdaPoinTr:
    cfg = branch_config(config, use_img=True, use_seg=True, seg_before_dec=True)
    return place(ImgEncSegDecAdaPoinTr(cfg), device, seed, dtype)
