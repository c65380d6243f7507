"""Kernel K1: the fused pointwise filter prefix, its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``rgie_tpu/ops/pallas/pointwise_chain.py``
(``fused_pointwise_chain`` -> ``_prefix_kernel``). The kernel itself is
Triton, in ``pointwise_chain_triton.py``; that module imports ``triton`` and
is imported only when a CUDA tensor is launched, so the CPU tests (which
have no Triton) import this module freely.

Dispatch: a CPU tensor runs ``reference_pointwise_chain``; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from rgie_tpu_torch.ops import filters as F
from rgie_tpu_torch.ops.chain import CURVE_KNOTS, FilterParams
from rgie_tpu_torch.ops.numerics import clip

#: Kernel launches (one per ``pointwise_chain`` call on a CUDA tensor). A
#: run resets it to 0 before the path it wants to check and reads it after.
LAUNCHES = 0

#: Pixels per program of the prefix pass (the contrast pass takes 4x as many
#: floats per program). The gray partial sums have one slot per prefix program.
PIXELS_PER_PROGRAM = 1024

_REPO_ROOT = Path(__file__).resolve().parents[3]


def pack_kernel_params(params: FilterParams) -> torch.Tensor:
    """(35,) f32: [exposure, saturation, tone 8, color 3x8 by channel,
    contrast] — the TPU kernel's (1, 34) SMEM layout plus the contrast."""
    return torch.cat([
        params.exposure[None], params.saturation[None], params.tone[:, 0],
        params.color.T.reshape(-1), params.contrast[None],
    ]).to(torch.float32).contiguous()


def reference_pointwise_chain(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    """The same sub-chain through the separate ops (K1's plain version; port
    of ``reference_pointwise_chain``)."""
    x = clip(F.apply_exposure(image, params.exposure), 0.0, 1.0)
    x = clip(F.apply_saturation(x, params.saturation), 0.0, 1.0)
    x = clip(F.apply_tone_curve(x, params.tone), 0.0, 1.0)
    x = clip(F.apply_color_curve(x, params.color), 0.0, 1.0)
    contrast = torch.where(params.contrast < 0, 0.0, params.contrast)
    return clip(F.apply_contrast(x, contrast), 0.0, 1.0)


def pointwise_chain(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    """exposure -> saturation -> tone -> color -> contrast on (B, H, W, 3) f32
    in [0, 1], one ``FilterParams`` (scalar fields) for the whole batch."""
    if image.ndim != 4 or image.shape[-1] != 3:
        raise ValueError(f"pointwise_chain takes (B, H, W, 3), got {tuple(image.shape)}")
    if params.exposure.ndim != 0 or params.tone.shape != (CURVE_KNOTS, 1):
        raise ValueError("pointwise_chain takes one parameter set (scalar fields)")
    if image.device.type == "cpu":
        return reference_pointwise_chain(image, params)
    if image.device.type != "cuda":
        raise ValueError(f"pointwise_chain: unsupported device {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"pointwise_chain kernel takes float32, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("pointwise_chain kernel takes a contiguous NHWC tensor")
    if image.numel() >= 2 ** 31:
        raise ValueError("pointwise_chain kernel indexes with int32: image too large")

    global LAUNCHES
    # Build the kernel from this checkout's source into an ignored directory.
    os.environ.setdefault("TRITON_CACHE_DIR", str(_REPO_ROOT / "build" / "triton"))
    from rgie_tpu_torch.ops.kernels import pointwise_chain_triton as K

    b, h, w, _ = image.shape
    n_prog = -(-(h * w) // PIXELS_PER_PROGRAM)
    packed = pack_kernel_params(params).to(image.device)
    out = torch.empty_like(image)
    partials = torch.empty((b, n_prog), dtype=torch.float32, device=image.device)
    K.launch(image, out, packed, partials, PIXELS_PER_PROGRAM)
    LAUNCHES += 1
    return out
