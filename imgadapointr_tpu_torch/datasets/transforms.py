"""Host-side (numpy) sample transforms.

The port's own copy of ``imgadapointr_tpu/datasets/transforms.py:15-151``.
Each random transform draws from the ``np.random.Generator`` the loader
hands the sample, in the order the JAX package draws, so a reader returns
the JAX reader's arrays bit for bit: :class:`Compose` draws one
``rng.uniform`` for every transform, even one that does not use it.
"""

from __future__ import annotations

import numpy as np


class Compose:
    """A list of ``{"callback", "parameters", "objects"}`` entries applied
    in order to the named keys of a sample dict."""

    def __init__(self, transforms):
        self.transformers = [{"callback": _TRANSFORMS[tr["callback"]](tr.get("parameters")),
                              "objects": tr["objects"]} for tr in transforms]

    def __call__(self, data: dict, rng: np.random.Generator) -> dict:
        for tr in self.transformers:
            transform, objects = tr["callback"], tr["objects"]
            rnd_value = rng.uniform(0, 1)  # drawn for every transform (the JAX order)
            if isinstance(transform, NormalizeObjectPose):
                data = transform(data)
                continue
            for k in list(data.keys()):
                if k in objects:
                    if isinstance(transform, RandomMirrorPoints):
                        data[k] = transform(data[k], rnd_value)
                    elif isinstance(transform, (RandomSamplePoints, UpSamplePoints)):
                        data[k] = transform(data[k], rng)
                    else:
                        data[k] = transform(data[k])
        return data


class ToArray:
    """Last transform: a contiguous float32 array (the reference's ToTensor)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(arr, dtype=np.float32)


class RandomSamplePoints:
    """A random permutation, the first n kept, zero rows appended if short."""

    def __init__(self, parameters):
        self.n_points = parameters["n_points"]

    def __call__(self, ptcloud: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        ptcloud = ptcloud[rng.permutation(ptcloud.shape[0])[: self.n_points]]
        if ptcloud.shape[0] < self.n_points:
            zeros = np.zeros((self.n_points - ptcloud.shape[0], 3), ptcloud.dtype)
            ptcloud = np.concatenate([ptcloud, zeros])
        return ptcloud


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


class RandomMirrorPoints:
    """An x, z or xz reflection (or none) chosen by the one uniform value
    :class:`Compose` drew for the transform, so partial and gt mirror alike."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, ptcloud: np.ndarray, rnd_value: float) -> np.ndarray:
        mat = np.eye(3, dtype=np.float32)
        mx = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        mz = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
        if rnd_value <= 0.25:
            mat = mx @ mz @ mat
        elif rnd_value <= 0.5:
            mat = mx @ mat
        elif rnd_value <= 0.75:
            mat = mz @ mat
        out = ptcloud.copy()
        out[:, :3] = ptcloud[:, :3] @ mat.T
        return out


class NormalizeObjectPose:
    """KITTI: the cloud in its bounding box's frame (centre, yaw, length),
    then y and z swapped."""

    def __init__(self, parameters):
        input_keys = parameters["input_keys"]
        self.ptcloud_key = input_keys["ptcloud"]
        self.bbox_key = input_keys["bbox"]

    def __call__(self, data: dict) -> dict:
        ptcloud, bbox = data[self.ptcloud_key], data[self.bbox_key]
        center = (bbox.min(0) + bbox.max(0)) / 2
        bbox = bbox - center
        yaw = np.arctan2(bbox[3, 1] - bbox[0, 1], bbox[3, 0] - bbox[0, 0])
        rotation = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                             [np.sin(yaw), np.cos(yaw), 0],
                             [0, 0, 1]])
        bbox = bbox @ rotation
        scale = bbox[3, 0] - bbox[0, 0]
        bbox = bbox / scale
        ptcloud = (ptcloud - center) @ rotation / scale
        ptcloud = ptcloud @ np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32)
        data[self.ptcloud_key] = ptcloud.astype(np.float32)
        data[self.bbox_key] = bbox.astype(np.float32)
        return data


_TRANSFORMS = {
    "ToTensor": ToArray,  # the reference's name, kept for its configs
    "ToArray": ToArray,
    "RandomSamplePoints": RandomSamplePoints,
    "UpSamplePoints": UpSamplePoints,
    "RandomMirrorPoints": RandomMirrorPoints,
    "NormalizeObjectPose": NormalizeObjectPose,
}
