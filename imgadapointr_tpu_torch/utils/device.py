"""Device selection and the port's float32 precision policy.

Entry points run on CUDA unless the caller asks for the CPU; if CUDA is
missing and the CPU was not asked for, they raise rather than drop to the
CPU. On CUDA, :func:`resolve_device` switches TF32 off for both matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
(``torch.backends.cudnn.allow_tf32``): the port's numerics are full fp32
on the card, matching the JAX package's HIGHEST-precision matmuls.

A train step runs under :func:`deterministic_cudnn`: cuDNN then picks only
algorithms that give the same bits on every run, so two train steps of
GRNet's 3-D U-Net from one state give bit-equal gradients, as every other
path of the port does (cuDNN's default algorithms for the transposed 3-D
convolution and the weight gradients add in no fixed order). Serving keeps
cuDNN's default choice: its deterministic 3-D algorithms are slower.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def deterministic_cudnn():
    """``torch.backends.cudnn.deterministic`` on for the block, then back to
    what it was (``torch.backends.cudnn.flags`` would also reset the other
    cuDNN flags to its own defaults: cuDNN off, TF32 on)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev
