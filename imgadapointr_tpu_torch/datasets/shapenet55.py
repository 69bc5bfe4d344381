"""ShapeNet-55/34 and KITTI readers.

The port's own copy of ``imgadapointr_tpu/datasets/shapenet55.py:25-103``:

- ``ShapeNet``: a file list over ``<DATA_PATH>/<subset>.txt``, lines
  ``<taxonomy>-<model>.npy`` under ``PC_PATH``; a sample is the complete
  cloud, a random ``N_POINTS`` of it, as both ``partial`` and ``gt`` (the
  crop protocols make the partial in training and in the test);
- ``KITTI``: the car scans and their bounding boxes of the samples the
  category file lists, in the box's frame (``NormalizeObjectPose``) and
  tiled up to ``N_POINTS``; ``gt`` is a (1, 3) zero (no ground truth).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.io_module import IO
from ..utils.registry import DATASETS
from .pcn_dataset import CARS_TAXONOMY
from .transforms import Compose


@DATASETS.register_module(name="ShapeNet")
class ShapeNet55:
    def __init__(self, config, **kw):
        self.pc_path = config.PC_PATH
        self.subset = config.others.subset if "others" in config else config.subset
        self.npoints = int(config.N_POINTS)
        with open(os.path.join(config.DATA_PATH, f"{self.subset}.txt")) as f:
            lines = [line.strip() for line in f if line.strip()]
        self.file_list = [{"taxonomy_id": line.split("-")[0],
                           "model_id": line.split("-", 1)[1].split(".")[0], "file_path": line}
                          for line in lines]
        self.transforms = Compose([
            {"callback": "RandomSamplePoints", "parameters": {"n_points": self.npoints}, "objects": ["gt"]},
            {"callback": "ToArray", "objects": ["gt"]},
        ])

    def __len__(self) -> int:
        return len(self.file_list)

    def get(self, idx: int, rng: np.random.Generator):
        sample = self.file_list[idx]
        gt = IO.get(os.path.join(self.pc_path, sample["file_path"])).astype(np.float32)
        data = self.transforms({"gt": gt}, rng)
        return sample["taxonomy_id"], sample["model_id"], {"partial": data["gt"], "gt": data["gt"]}


@DATASETS.register_module(name="KITTI")
class KITTI:
    def __init__(self, config, **kw):
        with open(config.CATEGORY_FILE_PATH) as f:
            samples = json.load(f)
        self.file_list = [{"model_id": s, "cloud": config.CLOUD_PATH % s, "bbox": config.BBOX_PATH % s}
                          for s in samples]
        self.transforms = Compose([
            {"callback": "NormalizeObjectPose",
             "parameters": {"input_keys": {"ptcloud": "partial", "bbox": "bbox"}},
             "objects": ["partial", "bbox"]},
            {"callback": "UpSamplePoints", "parameters": {"n_points": int(config.get("N_POINTS", 2048))},
             "objects": ["partial"]},
            {"callback": "ToArray", "objects": ["partial"]},
        ])

    def __len__(self) -> int:
        return len(self.file_list)

    def get(self, idx: int, rng: np.random.Generator):
        sample = self.file_list[idx]
        data = {"partial": IO.get(sample["cloud"]).astype(np.float32),
                "bbox": IO.get(sample["bbox"]).astype(np.float32)}
        data = self.transforms(data, rng)
        return CARS_TAXONOMY, sample["model_id"], {"partial": data["partial"],
                                                   "gt": np.zeros((1, 3), np.float32)}
