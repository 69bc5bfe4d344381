"""Synthetic PCN-shaped samples: the port's own copy of the numpy generator
in ``imgadapointr_tpu/datasets/synthetic.py:22-80``, images and class
one-hots included, so the port's requests are the samples the JAX
``--synthetic`` path makes for the same seed and index."""

from __future__ import annotations

import numpy as np

from ..utils.registry import DATASETS

_TAXONOMIES = [
    "02691156", "02933112", "02958343", "03001627",
    "03636649", "04256520", "04379243", "04530566",
]


def _surface_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random smooth closed surface: deformed ellipsoid point samples."""
    u = rng.uniform(0, 2 * np.pi, n)
    v = np.arccos(rng.uniform(-1, 1, n))
    radii = rng.uniform(0.2, 0.5, 3)
    bumps = rng.uniform(0.0, 0.15, 3)
    freq = rng.integers(1, 4, 3)
    r = 1.0 + bumps[0] * np.sin(freq[0] * u) + bumps[1] * np.cos(freq[1] * v)
    pts = np.stack(
        [
            radii[0] * r * np.sin(v) * np.cos(u),
            radii[1] * r * np.sin(v) * np.sin(u),
            radii[2] * (r + bumps[2] * np.sin(freq[2] * u)) * np.cos(v),
        ],
        axis=-1,
    )
    return pts.astype(np.float32)


@DATASETS.register_module(name="SyntheticPCN")
class SyntheticPCN:
    """PCN-shaped synthetic data. Config keys: N_POINTS (gt size),
    N_PARTIAL (default 2048), LENGTH, WITH_IMG (a 224x224x3 image in [0, 1)),
    WITH_CLS (a 16-way class one-hot), others.subset, SEED."""

    def __init__(self, config, **kw):
        self.npoints = int(config.get("N_POINTS", 16384))
        self.n_partial = int(config.get("N_PARTIAL", 2048))
        self.length = int(config.get("LENGTH", 64))
        self.with_img = bool(config.get("WITH_IMG", False))
        self.with_cls = bool(config.get("WITH_CLS", False))
        self.subset = config["others"]["subset"] if "others" in config else config.get("subset", "train")
        self.seed = int(config.get("SEED", 1234))

    def __len__(self):
        return self.length

    def get(self, idx: int, rng: np.random.Generator):
        # deterministic per (seed, idx): the sample ignores the pipeline rng
        srng = np.random.default_rng(self.seed * 100003 + idx)
        gt = _surface_points(srng, self.npoints)
        # partial = half-space crop, like PCN's camera-visible surface
        normal = srng.normal(size=3)
        normal /= np.linalg.norm(normal)
        side = gt @ normal > np.quantile(gt @ normal, 0.5)
        vis = gt[side]
        take = srng.integers(0, len(vis), self.n_partial)
        partial = vis[take] + srng.normal(0, 0.005, (self.n_partial, 3)).astype(np.float32)
        out = {"partial": partial.astype(np.float32), "gt": gt}
        if self.with_img:
            out["img"] = srng.uniform(0, 1, (224, 224, 3)).astype(np.float32)
        if self.with_cls:
            cls_vec = np.zeros(16, np.float32)
            cls_vec[idx % 16] = 1
            out["cls_vec"] = cls_vec
        return _TAXONOMIES[idx % len(_TAXONOMIES)], f"synthetic_{idx:06d}", out
