"""SnowFlakeNet (arXiv:2108.04444), the port's ``SnowFlakeNet``: a partial
cloud in; train: the seeds and the three SPD clouds, eval: P1 and P3."""

from .. import data, snowflake

INPUTS = ("partial",)


def build(cfg: dict) -> snowflake.SnowFlakeNet:
    return snowflake.SnowFlakeNet(cfg)


def sample(seed: int, idx: int, n_gt: int, n_partial: int) -> dict:
    return data.synthetic_sample(seed, idx, n_gt, n_partial, with_img=False, with_cls=False)


def step_flops(cfg: dict, n_points: int, train: bool) -> float:
    return snowflake.step_flops(cfg, n_points, train)
