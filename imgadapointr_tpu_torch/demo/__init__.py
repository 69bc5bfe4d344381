"""The programmatic serving API (``PCReconstructor``)."""

from .pcreconstructor import PCReconstructor

__all__ = ["PCReconstructor"]
