"""The general generator: a traffic file's parameters made into the run's
set-up, its measured window and the check of what the window produced.

A traffic file's ``kind`` names the module of :mod:`portbench.kinds` that
reads it (``kinds/<kind>.py``, its class ``KIND``, a subclass of
:class:`Run`); a configuration's model names its plain reference in
:mod:`portbench.reference.nets`. A new kind or model is a new file there.
Two kinds so far:

- ``train`` (:mod:`portbench.kinds.train`): ``Runner.train_step`` at the
  traffic's ``batch``, fed from a PCN tree on disk by the port's ``Loader``
  or from a pool of samples in device memory;
- ``serve`` (:mod:`portbench.kinds.serve`): an open loop of requests of
  ``batch`` clouds due at the times of the traffic's arrival process, each
  completed by ``Runner.predict`` and copied back.

A kind gives ``setup()``, ``window(seconds)`` (which may be called more than
once: a traced run measures the rate over an untraced stretch, then traces
the rest), ``release()``, ``check()`` and ``control()``. After the window
closes and the program's state is freed, the plain reference works out the
checked answers again from the same inputs and weights, and
:mod:`portbench.compare` sets the numbers that decide ``correct``.

The run gets the cell's first CUDA device; a kind whose cell takes several
chips starts and joins its own ranks on the others.
"""

from __future__ import annotations

import argparse
import gc
import importlib

import numpy as np
import torch

from . import weights
from .reference import nets


class Run:
    """One run of a cell: what the set-up, the window and the check share."""

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.run_cfg = cell.config["run"]
        self.model_cfg = self.run_cfg["model"]
        self.model_name = self.model_cfg["NAME"]
        self.net = nets.load(self.model_name)
        self.inputs = tuple(self.net.INPUTS)
        self.traffic = cell.traffic
        self.batch = int(self.traffic["batch"])
        self.detail = {}  # what the check saw beyond its numbers, for standard error

    # ------------------------------------------------------------- program
    def port_config(self):
        from imgadapointr_tpu_torch.utils.config import AttrDict

        return AttrDict(self.run_cfg)

    def build_runner(self):
        from imgadapointr_tpu_torch.tools.runner import Runner

        args = argparse.Namespace(seed=self.seed, device=str(self.device), tp=1, sp=1)
        runner = Runner(args, self.port_config())
        if tuple(runner.model.inputs) != self.inputs:
            raise ValueError(f"the model takes {runner.model.inputs}, the benchmark makes {self.inputs}")
        weights.load(runner.model, self.weights())
        return runner

    def weights(self) -> dict:
        return weights.make(self.model_name, self.model_cfg, self.seed, self.device)

    def reference(self) -> torch.nn.Module:
        model = self.net.build(self.model_cfg).to(self.device)
        weights.load(model, self.weights())
        return model

    def samples(self, n: int, seed: int) -> dict:
        """``n`` synthetic samples stacked, each with the model's inputs and gt."""
        ss = [self.net.sample(seed, i, int(self.traffic["n_gt"]), int(self.traffic["n_partial"])) for i in range(n)]
        return {k: torch.from_numpy(np.stack([s[k] for s in ss])) for k in ss[0]}

    # -------------------------------------------------------- what a kind gives
    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        """Measure for ``seconds``: {"seconds", "units" (steps or requests),
        "clouds", "attempted", "failed", "end_to_end": {metric: value}, ...}."""
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self) -> dict:
        raise NotImplementedError

    def control(self) -> dict:
        raise NotImplementedError


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sub_seed(seed: int, salt: int) -> int:
    return int(np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)[0] >> 1)


class tf32:
    """Full float32 for the reference (TF32 off for matmuls and cuDNN), or,
    for the control, TF32 on: the nearest precision below the configuration's."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev



def make(cell, seed: int, device, spans) -> Run:
    kind = cell.traffic["kind"]
    if not kind.isidentifier():
        raise ValueError(f"no traffic kind {kind!r}")
    return importlib.import_module(f"portbench.kinds.{kind}").KIND(cell, seed, device, spans)
