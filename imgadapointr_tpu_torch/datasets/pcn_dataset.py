"""The PCN dataset family: ``PCN``, ``PCNv2``, ``ImgPCN`` and ``SegImgPCN``.

The port's own copy of ``imgadapointr_tpu/datasets/pcn_dataset.py``: a
file list over the category file (``PCN.json``), each sample the partial
cloud of a random render (train; the first render otherwise), the complete
cloud, and for the image models one rendered view picked when the list is
built, from ``default_rng(seed)``, and a 16-way class one-hot. ``CARS``
keeps the car taxonomy only; ``N_RENDERINGS`` partials a train model.

Images are (224, 224, 3) float32 in [0, 1], channels-last: torchvision's
``Resize(224)`` (bilinear, the long side floored) then ``ToTensor``. PIL
is imported only when an image is read.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils.io_module import IO
from ..utils.registry import DATASETS
from .transforms import Compose

SEG_LIST = ["02691156", "03001627", "03636649", "04379243"]
CARS_TAXONOMY = "02958343"

CLASSES = {
    "02691156": 0, "02773838": 1, "02954340": 2, "02958343": 3, "03001627": 4,
    "03261776": 5, "03467517": 6, "03624134": 7, "03636649": 8, "03642806": 9,
    "03790512": 10, "03797390": 11, "03948459": 12, "04099429": 13,
    "04225987": 14, "04379243": 15,
}


def _load_image(path: str, size: int = 224) -> np.ndarray:
    """The image at ``path`` as RGB float32 in [0, 1], (size, size, 3): the
    shorter side resized to ``size`` bilinearly, the longer to
    ``int(long * size / short)``, then the top-left ``size`` x ``size``."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w <= h:
        img = img.resize((size, int(h * size / w)), Image.Resampling.BILINEAR)
    else:
        img = img.resize((int(w * size / h), size), Image.Resampling.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr[:size, :size]


_PCN_TRAIN_TRANSFORMS = [
    {"callback": "RandomSamplePoints", "parameters": {"n_points": 2048}, "objects": ["partial"]},
    {"callback": "RandomMirrorPoints", "objects": ["partial", "gt"]},
    {"callback": "ToArray", "objects": ["partial", "gt"]},
]
_PCN_EVAL_TRANSFORMS = [
    {"callback": "RandomSamplePoints", "parameters": {"n_points": 2048}, "objects": ["partial"]},
    {"callback": "ToArray", "objects": ["partial", "gt"]},
]


class BasePCNDataset:
    def __init__(self, config, include_images: bool = False, num_imgs_per_obj: int = 1,
                 include_segmentation: bool = False, seg_list=None, classes=None, seed: int = 0):
        self.partial_points_path = config.PARTIAL_POINTS_PATH
        self.complete_points_path = config.COMPLETE_POINTS_PATH
        self.npoints = config.N_POINTS
        self.subset = config.others.subset if "others" in config else config.subset
        self.include_images = include_images
        self.num_imgs_per_obj = num_imgs_per_obj
        self.include_segmentation = include_segmentation
        self.seg_list = seg_list
        self.classes = classes
        self._list_rng = np.random.default_rng(seed)
        if include_images:
            self.img_path = config.IMG_PATH
            self.img_idxs = list(range(24))
        with open(config.CATEGORY_FILE_PATH) as f:
            self.dataset_categories = json.load(f)
        if bool(config.get("CARS", False)):
            self.dataset_categories = [dc for dc in self.dataset_categories
                                       if dc["taxonomy_id"] == CARS_TAXONOMY]
        self.n_renderings = int(config.get("N_RENDERINGS", 8)) if self.subset == "train" else 1
        self.file_list = self._get_file_list(self.subset, self.n_renderings)
        self.transforms = Compose(_PCN_TRAIN_TRANSFORMS if self.subset == "train" else _PCN_EVAL_TRANSFORMS)

    def _get_file_list(self, subset: str, n_renderings: int = 1) -> list:
        file_list = []
        for dc in self.dataset_categories:
            for s in dc[subset]:
                detail = {
                    "taxonomy_id": dc["taxonomy_id"],
                    "model_id": s,
                    "partial_path": [self.partial_points_path % (subset, dc["taxonomy_id"], s, i)
                                     for i in range(n_renderings)],
                    "gt_path": self.complete_points_path % (subset, dc["taxonomy_id"], s),
                }
                if self.include_images:
                    # the render is picked while the list is built; the last pick wins
                    img_sample = self._list_rng.choice(self.img_idxs, size=self.num_imgs_per_obj,
                                                       replace=False)
                    detail["img_path"] = self.img_path % (subset, dc["taxonomy_id"], s, int(img_sample[-1]))
                if self.include_segmentation:
                    cls_vec = np.zeros(16, np.float32)
                    if dc["taxonomy_id"] in self.seg_list:
                        cls_vec[self.classes[dc["taxonomy_id"]]] = 1
                    detail["cls_vec"] = cls_vec
                file_list.append(detail)
        return file_list

    def __len__(self) -> int:
        return len(self.file_list)

    def get(self, idx: int, rng: np.random.Generator):
        """``(taxonomy_id, model_id, {"partial", "gt"[, "img"][, "cls_vec"]})``
        of sample ``idx``, its randomness drawn from ``rng``."""
        sample = self.file_list[idx]
        rand_idx = int(rng.integers(0, self.n_renderings)) if self.subset == "train" else 0
        data = {"partial": IO.get(sample["partial_path"][rand_idx]).astype(np.float32),
                "gt": IO.get(sample["gt_path"]).astype(np.float32)}
        data = self.transforms(data, rng)
        out = {"partial": data["partial"], "gt": data["gt"]}
        if self.include_images:
            out["img"] = _load_image(sample["img_path"])
        if "cls_vec" in sample:
            out["cls_vec"] = sample["cls_vec"]
        return sample["taxonomy_id"], sample["model_id"], out


@DATASETS.register_module(name="PCN")
class PCN(BasePCNDataset):
    pass


@DATASETS.register_module(name="PCNv2")
class PCNv2(BasePCNDataset):
    """PCN with the partial tiled up to 2048 points (``UpSamplePoints``)
    where ``PCN`` zero-pads it."""

    def __init__(self, config, **kw):
        super().__init__(config, **kw)
        mirror = ([{"callback": "RandomMirrorPoints", "objects": ["partial", "gt"]}]
                  if self.subset == "train" else [])
        self.transforms = Compose(
            [{"callback": "UpSamplePoints", "parameters": {"n_points": 2048}, "objects": ["partial"]}]
            + mirror + [{"callback": "ToArray", "objects": ["partial", "gt"]}])


@DATASETS.register_module(name="ImgPCN")
class ImgPCN(BasePCNDataset):
    def __init__(self, config, num_imgs_per_obj: int = 1, **kw):
        super().__init__(config, include_images=True, num_imgs_per_obj=num_imgs_per_obj, **kw)


@DATASETS.register_module(name="SegImgPCN")
class SegImgPCN(BasePCNDataset):
    def __init__(self, config, num_imgs_per_obj: int = 6, **kw):
        super().__init__(config, include_images=True, num_imgs_per_obj=num_imgs_per_obj,
                         include_segmentation=True, seg_list=SEG_LIST, classes=CLASSES, **kw)
