from .config import AttrDict, cfg_from_yaml_file, get_config
from .device import resolve_device
from .registry import MODELS

__all__ = ["AttrDict", "cfg_from_yaml_file", "get_config", "resolve_device", "MODELS"]
