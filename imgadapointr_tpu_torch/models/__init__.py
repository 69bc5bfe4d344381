"""Models of the port, registered in ``utils.registry.MODELS``."""

from .adapointr import AdaPoinTr, build_model
from .img_adapointr import ImgAdaPoinTr
from .seg_adapointr import ImgEncSegDecAdaPoinTr, SegEncAdaPoinTr

__all__ = ["AdaPoinTr", "ImgAdaPoinTr", "ImgEncSegDecAdaPoinTr", "SegEncAdaPoinTr", "build_model"]
