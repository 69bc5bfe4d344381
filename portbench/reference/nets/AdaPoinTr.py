"""AdaPoinTr (arXiv:2301.04545), the port's ``AdaPoinTr``: a partial cloud in,
the coarse and fine clouds out."""

from .. import data, flops, models

INPUTS = ("partial",)


def build(cfg: dict) -> models.AdaPoinTr:
    return models.AdaPoinTr(cfg)


def sample(seed: int, idx: int, n_gt: int, n_partial: int) -> dict:
    return data.synthetic_sample(seed, idx, n_gt, n_partial, with_img=False, with_cls=False)


def step_flops(cfg: dict, n_points: int, train: bool) -> float:
    return flops.step_flops(cfg, n_points, train)
