"""Explicit device selection for the port's entry points.

``--device cuda`` means the CUDA device or an error: nothing here swaps in the
CPU when CUDA is missing. The CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """Turn a ``--device`` value into a ``torch.device``; raise if it is CUDA
    and CUDA is unavailable. Also fixes the float32 precision (see below)."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} was requested but CUDA is not available")
    # Full float32 everywhere: the JAX CLI runs f32 and the CPU reference the
    # port is held to is full f32. cuDNN convolutions default to TF32 (about
    # three decimal digits); matmuls are set explicitly too. TF32 and bf16
    # autocast are performance levers for later, measured against this.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device

