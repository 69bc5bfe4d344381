"""Models of the port, registered in ``utils.registry.MODELS``."""

from .adapointr import AdaPoinTr, build_model

__all__ = ["AdaPoinTr", "build_model"]
