"""Device selection and the port's float32 precision policy.

Entry points run on CUDA unless the caller asks for the CPU; if CUDA is
missing and the CPU was not asked for, they raise rather than drop to the
CPU. On CUDA, :func:`resolve_device` switches TF32 off for both matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
(``torch.backends.cudnn.allow_tf32``): the port's numerics are full fp32
on the card, matching the JAX package's HIGHEST-precision matmuls.
"""

from __future__ import annotations

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
