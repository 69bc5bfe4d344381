"""The plain reference of each model the benchmark runs: one file a model,
named by the port's registry name (a configuration's ``run.model.NAME``).

A file gives ``INPUTS`` (the model's input names, in call order),
``build(cfg)`` (the reference module, from the configuration's ``model``),
``sample(seed, idx, n_gt, n_partial)`` (one synthetic sample: the inputs as
numpy arrays and the complete cloud ``gt``) and
``step_flops(cfg, n_points, train)`` (the model's FLOPs a cloud, the
backward included in training). A new model is a new file here.
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The module of model ``name``."""
    if not name.isidentifier():
        raise ValueError(f"no reference model {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
