from .config import AttrDict, cfg_from_yaml_file
from .device import resolve_device
from .registry import MODELS

__all__ = ["AttrDict", "cfg_from_yaml_file", "resolve_device", "MODELS"]
