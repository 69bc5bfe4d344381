"""Checkpoints with the reference's best / last / final-epochs policy.

Counterpart of ``imgadapointr_tpu/utils/checkpoint.py``. A checkpoint is
one ``.pth`` holding ``base_model`` (the model's state dict in the
reference layout, so the serving CLI and ``--ckpts`` read it as they read
a reference checkpoint), ``optimizer`` (``torch.optim.AdamW.state_dict()``),
``epoch``, ``step``, ``metrics`` and ``best_metrics``. It is written to a
temporary name in the same directory, fsynced and renamed into place: a
kill at any instant leaves the previous complete file.
"""

from __future__ import annotations

import os

import torch

from .logger import print_log


def checkpoint_path(prefix: str, experiment_path: str) -> str:
    return os.path.join(experiment_path, prefix + ".pth")


def save_checkpoint(model, optimizer, epoch: int, step: int, metrics, best_metrics,
                    prefix: str, experiment_path: str, logger=None) -> str:
    os.makedirs(experiment_path, exist_ok=True)
    path = checkpoint_path(prefix, experiment_path)
    payload = {
        "base_model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": epoch,
        "step": step,
        "metrics": metrics,
        "best_metrics": best_metrics,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    print_log(f"Save checkpoint at {path}", logger)
    return path


def load_checkpoint(path: str, model, optimizer=None) -> dict:
    """Load ``path`` into ``model`` (strictly) and, if given, ``optimizer``;
    returns the rest (``epoch``, ``step``, ``metrics``, ``best_metrics``)."""
    # read on the CPU: load_state_dict copies weights and moments to the
    # parameters' device and leaves AdamW's step counters where torch keeps them
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(raw["base_model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(raw["optimizer"])
    return {k: raw.get(k) for k in ("epoch", "step", "metrics", "best_metrics")}
