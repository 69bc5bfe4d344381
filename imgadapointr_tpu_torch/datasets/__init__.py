"""Request sources: the synthetic PCN generator and the host-side transforms."""

from .synthetic import SyntheticPCN
from .transforms import UpSamplePoints

__all__ = ["SyntheticPCN", "UpSamplePoints"]
