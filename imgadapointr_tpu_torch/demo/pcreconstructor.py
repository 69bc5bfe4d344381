"""The programmatic serving API, counterpart of ``demo/pcreconstructor.py``
of the JAX package (its lines 20-106).

Usage:
    from imgadapointr_tpu_torch.demo import PCReconstructor
    rec = PCReconstructor("cfgs/SegImgPCN_models/ImgEncSegDecAdaPoinTrVariableLoss.yaml",
                          "ckpt-best.pth")            # or a JAX .ckpt; device="cuda"
    fine = rec.predict("cloud.pcd", "render.png", "03001627", CLASSES)

It serves every model the port builds, the image and segmentation models
among them (the CLI reads clouds only). The checkpoint is a
reference-layout ``.pth`` / ``.pt`` (the port's own among them) or a JAX
``.ckpt``; without one the weights are the seed-0 init. The preprocessing
is the JAX API's: the first 2048 points of the cloud, tiled up when there
are fewer (not the CLI's ``UpSamplePoints``); the image as the PCN readers
load it; the class as a one-hot of 16. :meth:`PCReconstructor.forward`
takes decoded arrays and is the part that runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..datasets.pcn_dataset import _load_image
from ..models import build_model
from ..tools.convert import load_weights
from ..utils.config import cfg_from_yaml_file
from ..utils.device import resolve_device
from ..utils.io_module import IO

NUM_POINTS = 2048
IMG_SIZE = 224
NUM_CLASSES = 16


class PCReconstructor:
    def __init__(self, config_path: str, ckpt_path: str | None, device: str = "cuda"):
        self.config = cfg_from_yaml_file(config_path)
        self.device = resolve_device(device)
        self.model = build_model(self.config.model, device=self.device)
        self.inputs = tuple(self.model.inputs)
        if ckpt_path:
            load_weights(self.model, ckpt_path, self.config.model)
        self.model.eval()

    def predict(self, point_cloud_path: str, image_path: str | None = None, class_id=None,
                classes: dict | None = None) -> np.ndarray:
        """The dense completion (N, 3) of the cloud at ``point_cloud_path``,
        with the image at ``image_path`` and the one-hot of
        ``classes[class_id]`` for the models that take them."""
        partial = self.preprocess_point_cloud(point_cloud_path)
        img = self.load_image(image_path) if "img" in self.inputs else None
        cls_vec = self.prepare_cls_vec(classes or {}, class_id) if "cls_vec" in self.inputs else None
        return self.forward(partial, img, cls_vec)

    @torch.inference_mode()
    def forward(self, partial: np.ndarray, img: np.ndarray | None = None,
                cls_vec: np.ndarray | None = None) -> np.ndarray:
        """The dense completion of the first cloud of ``partial`` (1, N, 3),
        with ``img`` (1, H, W, 3) in [0, 1] and ``cls_vec`` (1, 16) where the
        model takes them."""
        given = {"partial": partial, "img": img, "cls_vec": cls_vec}
        missing = [k for k in self.inputs if given[k] is None]
        if missing:
            raise ValueError(f"{self.config.model.NAME} takes {self.inputs}; missing {missing}")
        args = [torch.from_numpy(np.ascontiguousarray(given[k], dtype=np.float32)).to(self.device)
                for k in self.inputs]
        return self.model(*args)[-1][0].cpu().numpy()

    @staticmethod
    def preprocess_point_cloud(path: str) -> np.ndarray:
        """(1, NUM_POINTS, 3): the cloud's first ``NUM_POINTS`` points, tiled
        up to that many when it has fewer."""
        pc = IO.get(path).astype(np.float32)[:NUM_POINTS]
        if len(pc) < NUM_POINTS:
            reps = -(-NUM_POINTS // len(pc))
            pc = np.tile(pc, (reps, 1))[:NUM_POINTS]
        return pc[None]

    @staticmethod
    def load_image(path: str) -> np.ndarray:
        """(1, IMG_SIZE, IMG_SIZE, 3) in [0, 1], as the PCN readers load a
        render (PIL)."""
        return _load_image(path, IMG_SIZE)[None]

    @staticmethod
    def prepare_cls_vec(classes: dict, class_id) -> np.ndarray:
        """(1, 16) one-hot of ``classes[class_id]``; all zeros for a class
        ``classes`` does not hold."""
        cls_vec = np.zeros((1, NUM_CLASSES), np.float32)
        idx = classes.get(class_id, -1)
        if idx != -1:
            cls_vec[0, idx] = 1
        return cls_vec
