"""Checkpoints with the reference's best / last / final-epochs policy.

Counterpart of ``imgadapointr_tpu/utils/checkpoint.py``. A checkpoint is
one ``.pth`` holding ``base_model`` (the model's state dict in the
reference layout, so the serving CLI and ``--ckpts`` read it as they read
a reference checkpoint), ``optimizer`` (``torch.optim.AdamW.state_dict()``),
``epoch``, ``step``, ``metrics``, ``best_metrics``, ``generator``, the
state of the runner's generator of the train draws (with its device
type), so that a resumed run on the same kind of device draws what an
uninterrupted one would, and, when it is saved between the batches of one
``step_per_update`` sum, ``pending_grads``: that sum so far, by parameter
name, which the load puts back into the parameters' ``grad``. It is written to a
temporary name in the same directory, fsynced and renamed into place: a
kill at any instant leaves the previous complete file.

The JAX package's own checkpoints are read too (:func:`load_jax_checkpoint`):
``<prefix>.ckpt``, a flax msgpack payload of ``params``, ``batch_stats``,
``opt_state`` and ``step``, beside ``<prefix>.ckpt.json`` with ``epoch``,
``metrics`` and ``best_metrics`` (``imgadapointr_tpu/utils/checkpoint.py:49-118``).
The port writes none.
"""

from __future__ import annotations

import json
import os

import torch

from . import flax_msgpack
from .logger import print_log

JAX_SUFFIX = ".ckpt"


def checkpoint_path(prefix: str, experiment_path: str) -> str:
    return os.path.join(experiment_path, prefix + ".pth")


def save_checkpoint(model, optimizer, epoch: int, step: int, metrics, best_metrics,
                    prefix: str, experiment_path: str, logger=None, generator=None,
                    pending_grads: dict | None = None) -> str:
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
    if pending_grads:
        payload["pending_grads"] = pending_grads
    if generator is not None:
        payload["generator"] = {"device": generator.device.type, "state": generator.get_state()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    print_log(f"Save checkpoint at {path}", logger)
    return path


def load_checkpoint(path: str, model, optimizer=None, generator=None) -> dict:
    """Load ``path`` into ``model`` (strictly; a pending gradient sum into
    its parameters' ``grad``) and, if given, ``optimizer`` and
    ``generator`` (left as it is by a checkpoint without a generator state
    or with one of another device type, whose state has another layout);
    returns the rest (``epoch``, ``step``, ``metrics``,
    ``best_metrics``)."""
    # read on the CPU: load_state_dict copies weights and moments to the
    # parameters' device and leaves AdamW's step counters where torch keeps them
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(raw["base_model"], strict=True)
    set_pending_grads(model, raw.get("pending_grads") or {})
    if optimizer is not None:
        optimizer.load_state_dict(raw["optimizer"])
    saved = raw.get("generator")
    if generator is not None and saved is not None and saved["device"] == generator.device.type:
        generator.set_state(saved["state"])
    return {k: raw.get(k) for k in ("epoch", "step", "metrics", "best_metrics")}


def set_pending_grads(model, grads: dict) -> None:
    """Each parameter's ``grad`` from ``grads`` (name -> tensor, on any
    device), None where it has no entry: the state of a ``step_per_update``
    sum between its batches."""
    for name, p in model.named_parameters():
        g = grads.get(name)
        p.grad = None if g is None else torch.empty_like(p).copy_(g)


def resolve_jax_checkpoint(path: str, experiment_path: str | None = None) -> str:
    """The ``.ckpt`` file ``path`` names, as the JAX runner resolves
    ``--start_ckpts`` (``imgadapointr_tpu/tools/runner.py:587-624``): a
    ``.ckpt`` path or a bare prefix (``.ckpt`` added), else the same name
    inside ``experiment_path``. Raises when neither is a file."""
    file = path if path.endswith(JAX_SUFFIX) else path + JAX_SUFFIX
    if os.path.isfile(file):
        return file
    tried = [file]
    if experiment_path:
        in_exp = os.path.join(experiment_path, file)
        if os.path.isfile(in_exp):
            return in_exp
        tried.append(in_exp)
    raise FileNotFoundError(f"no JAX checkpoint at {path!r} (tried {' and '.join(tried)})")


def load_jax_checkpoint(path: str) -> tuple[dict, dict]:
    """``(tree, meta)`` of a JAX checkpoint: ``tree`` is the payload
    (``params``, ``batch_stats`` and, from a train state, ``opt_state`` and
    ``step``) as nested dicts of numpy arrays; ``meta`` is the
    ``.ckpt.json`` sidecar (``epoch``, ``metrics``, ``best_metrics``), ``{}``
    when there is none."""
    tree = flax_msgpack.read(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: no 'params' tree in the checkpoint")
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return tree, meta
