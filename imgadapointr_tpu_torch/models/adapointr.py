"""AdaPoinTr, the flagship completion model.

Counterpart of ``imgadapointr_tpu/models/adapointr.py:35-116``:
PCTransformer core, ``increase_dim`` (1x1 conv -> BN -> LeakyReLU -> 1x1
conv, then a max), ``reduce_map`` over cat(global, token, coarse), the
rebuild head (``decoder_type: fc``, or ``fold``: the folding head over each
token, 64 points a query whatever ``num_points`` says), and
``rebuild_points + coarse``. In train mode every dropout and DropPath layer
draws its masks from the forward's ``generator``, after the denoise
jitter's draw.
In eval mode it returns ``(coarse (B, num_query, 3), fine (B, num_query *
factor, 3))``; in train mode ``(pred_coarse, denoised_coarse, denoised_fine,
pred_fine)``, the last ``DENOISE_LENGTH`` queries being the denoise task's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.heads import Fold, SimpleRebuildFCLayer
from ..nn.layers import (BatchNorm, ConcatDense, Linear, init_weights_, set_dropout_generator,
                         stochastic_layers)
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.registry import MODELS
from .losses import adapointr_loss, variable_alpha
from .pctransformer import PCTransformer


FOLD_STEP = 8  # reference AdaPoinTr.py:167


def rebuild_factor(config) -> int:
    """Points rebuilt per query token (reference AdaPoinTr.py:170-180):
    FOLD_STEP² under ``decoder_type: fold``, else ``num_points / num_query``."""
    num_points = config.get("num_points", None)
    if config.decoder_type == "fold" or num_points is None:
        return FOLD_STEP**2
    if num_points % config.num_query:
        raise ValueError("num_points must be a multiple of num_query")
    return num_points // config.num_query


class AdaPoinTr(nn.Module):
    # the batch entries the model takes, in the order of its arguments
    inputs = ("partial",)
    # the coarse term's weight: 1, or the variable-loss schedule of the epoch
    variable_loss = False

    def __init__(self, config):
        super().__init__()
        if config.decoder_type not in ("fc", "fold"):
            raise ValueError(f"decoder_type {config.decoder_type!r}: 'fc' or 'fold'")
        trans_dim = int(config.decoder_config.embed_dim)
        self.base_model = PCTransformer(config)
        # reference Sequential(Conv1d(C, 1024, 1), BatchNorm1d(1024), LeakyReLU(0.2), Conv1d(1024, 1024, 1))
        self.increase_dim = nn.Sequential(
            Linear(trans_dim, 1024, kernel_dims=1), BatchNorm(1024), nn.LeakyReLU(0.2),
            Linear(1024, 1024, kernel_dims=1),
        )
        self.reduce_map = ConcatDense((1024, trans_dim, 3), trans_dim)
        self.factor = rebuild_factor(config)
        self.decode_head = (Fold(trans_dim, step=FOLD_STEP, hidden_dim=256)
                            if config.decoder_type == "fold"
                            else SimpleRebuildFCLayer(trans_dim * 2, step=self.factor))
        # every BatchNorm takes the call's momentum (GDANet's stay in eval mode)
        self._batchnorms = tuple(m for m in self.modules() if isinstance(m, BatchNorm))
        self._stochastic = stochastic_layers(self)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None, img_feat: torch.Tensor | None = None,
                seg_fn=None, cls_vec: torch.Tensor | None = None):
        """``bn_momentum`` is the torch-style BatchNorm momentum of this call
        (the BN-momentum schedule's value); ``generator`` / ``noise`` feed
        the denoise jitter (see :class:`PCTransformer`), then the dropout
        and DropPath masks. All three matter in train mode only.
        ``img_feat``, ``seg_fn`` and ``cls_vec`` feed the image and
        segmentation branches of the models built on this one
        (``models/img_adapointr.py``, ``models/seg_adapointr.py``)."""
        for bn in self._batchnorms:
            bn.momentum = bn_momentum
        set_dropout_generator(self._stochastic, generator)
        q, coarse, L = self.base_model(xyz, img_feat=img_feat, seg_fn=seg_fn, cls_vec=cls_vec,
                                       generator=generator, noise=noise)
        B = q.shape[0]
        with trace.span("model.head"):
            global_feature = self.increase_dim(q).amax(dim=1)  # (B, 1024)
            rf = self.reduce_map(global_feature[:, None], q, coarse)
            if isinstance(self.decode_head, Fold):
                M, C = rf.shape[1:]
                relative = self.decode_head(rf.reshape(B * M, C)).reshape(B, M, self.factor, 3)
            else:
                relative = self.decode_head(rf)
            rebuild = relative + coarse[:, :, None]  # (B, M, S, 3)
            if not self.training:
                return coarse, rebuild.reshape(B, -1, 3)
            pred_fine = rebuild[:, :-L].reshape(B, -1, 3)
            denoised_fine = rebuild[:, -L:].reshape(B, -1, 3)
            return coarse[:, :-L], coarse[:, -L:], denoised_fine, pred_fine

    def loss(self, ret, gt: torch.Tensor, epoch_f: float):
        """``(loss_denoised, loss_recon)`` of the train-mode return ``ret``
        at the float epoch ``epoch_f`` (the JAX package's
        ``ModelSpec.loss_fn``)."""
        alpha = variable_alpha(epoch_f) if self.variable_loss else 1.0
        return adapointr_loss(ret, gt, self.factor, coarse_alpha=alpha)


class AdaPoinTrVariableLoss(AdaPoinTr):
    """AdaPoinTr trained with the variable coarse loss (the point-only
    ablation, ``imgadapointr_tpu/models/img_adapointr.py:67-78``)."""

    variable_loss = True


def place(model: nn.Module, device="cuda", seed: int = 0,
          dtype: torch.dtype = torch.float32) -> nn.Module:
    """``model`` with its seeded init (:func:`init_weights_`), in eval mode
    on ``device`` (load a checkpoint over the weights with
    ``load_state_dict``)."""
    dev = resolve_device(device)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, dtype=dtype).eval()


@MODELS.register_module(name="AdaPoinTr")
def build_adapointr(config, device="cuda", seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> AdaPoinTr:
    """AdaPoinTr in eval mode on ``device``, weights from a seeded flax-style
    init (load a checkpoint over them with ``load_state_dict``)."""
    return place(AdaPoinTr(config), device, seed, dtype)


@MODELS.register_module(name="AdaPoinTrVariableLoss")
def build_adapointr_variable_loss(config, device="cuda", seed: int = 0,
                                  dtype: torch.dtype = torch.float32) -> AdaPoinTrVariableLoss:
    return place(AdaPoinTrVariableLoss(config), device, seed, dtype)


def build_model(config, device="cuda", seed: int = 0, dtype: torch.dtype = torch.float32):
    """Build ``config.NAME`` from the port's registry."""
    return MODELS.build(config, device=device, seed=seed, dtype=dtype)
