"""YAML config system with ``_base_`` inheritance (attribute-style dicts).

The port's own copy of ``imgadapointr_tpu/utils/config.py:21-102``: YAML
files under ``cfgs/`` with recursive ``_base_`` includes, loaded into
attribute-accessible dicts.
"""

from __future__ import annotations

import copy
import os
from collections.abc import Mapping
from typing import Any

import yaml


class AttrDict(dict):
    """dict with attribute access, recursively converting nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d) if d else {}
        d.update(kwargs)
        for k, v in d.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def update(self, other=None, **kwargs):  # dict.update bypasses __setitem__
        for k, v in dict(other or {}, **kwargs).items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(v):
    if isinstance(v, Mapping) and not isinstance(v, AttrDict):
        return AttrDict(dict(v))
    if isinstance(v, (list, tuple)):
        return tuple(_wrap(x) for x in v)
    return v


def _deep_merge(child, base):
    """Child wins per key; dicts merge recursively, so overriding one
    sub-key of a nested base dict keeps the base's other sub-keys."""
    if isinstance(child, Mapping) and isinstance(base, Mapping):
        merged = dict(base)
        for k, v in child.items():
            merged[k] = _deep_merge(v, base[k]) if k in base else v
        return merged
    return child


def _merge_base(cfg: dict, root: str) -> dict:
    """Recursively resolve ``_base_`` keys."""
    out = {}
    base = None
    for k, v in cfg.items():
        if k == "_base_":
            base = cfg_from_yaml_file(os.path.join(root, v) if not os.path.isabs(v) else v)
        elif isinstance(v, dict):
            out[k] = _merge_base(v, root)
        else:
            out[k] = v
    if base is not None:
        out = _deep_merge(out, base)
    return out


def cfg_from_yaml_file(path: str, root: str | None = None) -> AttrDict:
    """Load a YAML config, resolving ``_base_`` includes relative to ``root``
    (defaults to the current working directory, the repo's relative
    'cfgs/...' convention)."""
    root = root or os.getcwd()
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return AttrDict(_merge_base(raw, root))
