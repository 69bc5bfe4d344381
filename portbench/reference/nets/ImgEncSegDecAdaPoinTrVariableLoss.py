"""ImgEncSegDecAPTr of mmkuznecov/ImgAdaPoinTr, the port's
``ImgEncSegDecAdaPoinTrVariableLoss``: the AdaPoinTr trunk with ResNet18 image
fusion after the encoder, frozen GDANet segmentation fusion on the decoder
queries and the variable coarse loss; a partial cloud, an image and a class
one-hot in."""

from .. import data, flops, models

INPUTS = ("partial", "img", "cls_vec")


def build(cfg: dict) -> models.AdaPoinTr:
    return models.AdaPoinTr(cfg, use_img=True, use_seg=True, variable_loss=True)


def sample(seed: int, idx: int, n_gt: int, n_partial: int) -> dict:
    return data.synthetic_sample(seed, idx, n_gt, n_partial, with_img=True, with_cls=True)


def step_flops(cfg: dict, n_points: int, train: bool) -> float:
    return flops.step_flops(cfg, n_points, train, superset=True)
