"""The port's own model and dataset registries (the JAX package's names
would clash in its registries)."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def keys(self):
        return sorted(self._module_dict)

    def register_module(self, name: str | None = None):
        """Decorator: ``@REG.register_module(name="X")``."""

        def deco(cls):
            key = name or cls.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} is already registered in {self.name}")
            self._module_dict[key] = cls
            return cls

        return deco

    def build(self, cfg, **kwargs) -> Any:
        """Build ``self._module_dict[cfg.NAME](cfg, **kwargs)``."""
        name = cfg.get("NAME")
        if name not in self._module_dict:
            raise KeyError(
                f"{name!r} is not in the {self.name} registry; available: {self.keys()}"
            )
        return self._module_dict[name](cfg, **kwargs)


MODELS = Registry("model")
DATASETS = Registry("dataset")
