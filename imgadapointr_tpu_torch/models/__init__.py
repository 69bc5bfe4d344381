"""Models of the port, registered in ``utils.registry.MODELS``."""

from .adapointr import AdaPoinTr, build_model
from .baselines import BASELINES, PCN, FoldingNet, TopNet
from .grnet import GRNet
from .img_adapointr import ImgAdaPoinTr
from .seg_adapointr import ImgEncSegDecAdaPoinTr, SegEncAdaPoinTr
from .snowflakenet import SnowFlakeNet

__all__ = ["BASELINES", "AdaPoinTr", "FoldingNet", "GRNet", "ImgAdaPoinTr", "ImgEncSegDecAdaPoinTr", "PCN",
           "SegEncAdaPoinTr", "SnowFlakeNet", "TopNet", "build_model"]
