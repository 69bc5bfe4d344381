"""Readers (registered in ``DATASETS`` by their config ``NAME``), the
host-side transforms and the loader."""

from ..utils.registry import DATASETS
from . import pcn_dataset, shapenet55  # noqa: F401  (register PCN, PCNv2, ImgPCN, SegImgPCN, ShapeNet, KITTI)
from .loader import Loader
from .synthetic import SyntheticPCN
from .transforms import Compose, UpSamplePoints

__all__ = ["DATASETS", "Loader", "SyntheticPCN", "Compose", "UpSamplePoints"]
