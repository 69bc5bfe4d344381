"""Host-side cloud transforms (copies from ``imgadapointr_tpu/datasets/transforms.py``)."""

from __future__ import annotations

import numpy as np


class UpSamplePoints:
    """Tile + random-subset upsample (or random subset down) to n points."""

    def __init__(self, parameters):
        self.n_points = parameters["n_points"]

    def __call__(self, ptcloud: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        curr = ptcloud.shape[0]
        need = self.n_points - curr
        if need < 0:
            return ptcloud[rng.permutation(self.n_points)]
        while curr <= need:
            ptcloud = np.tile(ptcloud, (2, 1))
            need -= curr
            curr *= 2
        choice = rng.permutation(need)
        return np.concatenate([ptcloud, ptcloud[choice]])
