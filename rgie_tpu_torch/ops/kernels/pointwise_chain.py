"""Kernel K1: the fused pointwise filter prefix and the contrast after it,
its wrapper and its plain PyTorch versions.

Replaces the TPU kernel ``rgie_tpu/ops/pallas/pointwise_chain.py``
(``fused_pointwise_chain`` -> ``_prefix_kernel``, and the contrast pass
after it). The kernel is CUDA C++, ``rgie_tpu_torch/csrc/pointwise_chain.cu``
(its note says what bounds it and what the design does about that), built
with ``nvcc`` at the first launch (``build.py``) and called through
``ctypes``: one C call launches both of its passes on PyTorch's current
stream and reads the parameters where the ``FilterParams`` tensors lie.

Dispatch: a CPU tensor runs ``two_pass_pointwise_chain``, the kernel's order
in plain PyTorch; a CUDA tensor launches the kernel or raises. There is no
fallback between the two. ``reference_pointwise_chain`` (the separate ops)
is what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rgie_tpu_torch.ops import color as C
from rgie_tpu_torch.ops import filters as F
from rgie_tpu_torch.ops.chain import CURVE_KNOTS, FilterParams
from rgie_tpu_torch.ops.kernels import build
from rgie_tpu_torch.ops.numerics import clip

#: Kernel launches (one per ``pointwise_chain`` call on a CUDA tensor). A
#: run resets it to 0 before the path it wants to check and reads it after.
LAUNCHES = 0

KERNEL_SOURCE = "pointwise_chain"

#: Pixels a block of the kernel takes (``kPixels`` in the source): one gray
#: partial sum per block and image.
PIXELS_PER_BLOCK = 2048


def reference_pointwise_chain(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    """The same sub-chain through the separate ops (K1's plain version; port
    of ``reference_pointwise_chain``)."""
    x = clip(F.apply_exposure(image, params.exposure), 0.0, 1.0)
    x = clip(F.apply_saturation(x, params.saturation), 0.0, 1.0)
    x = clip(F.apply_tone_curve(x, params.tone), 0.0, 1.0)
    x = clip(F.apply_color_curve(x, params.color), 0.0, 1.0)
    contrast = torch.where(params.contrast < 0, 0.0, params.contrast)
    return clip(F.apply_contrast(x, contrast), 0.0, 1.0)


def _table_curve(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The 8-knot curve as the kernel evaluates it: for v in [0, 1] and k =
    min(floor(8 v), 7), ``C_k + (v - k/8) w_k``, with ``C_k`` the running sum
    of ``w_j / 8`` over the knots below k taken in the knots' order. It
    equals the knot-by-knot sum of ``clip(v - i/8, 0, 1/8) w_i``: the knots
    below k add ``w_i / 8`` exactly and those above add zeros. ``weights``:
    (8, 1) shared by the channels or (8, 3) one per channel."""
    w = weights.to(x.dtype).expand(CURVE_KNOTS, 3)
    running = [torch.zeros_like(w[0])]
    for j in range(CURVE_KNOTS - 1):
        running.append(running[-1] + 0.125 * w[j])
    table = torch.stack(running)                              # (8, 3)
    k = torch.clamp((x * 8.0).to(torch.int64), max=CURVE_KNOTS - 1)
    channel = torch.arange(3, device=x.device).expand_as(k)
    y = table[k, channel] + (x - k.to(x.dtype) * 0.125) * w[k, channel]
    return clip(torch.minimum(y, torch.ones_like(y)), 0.0, 1.0)


def _prefix(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    x = clip(F.apply_exposure(image, params.exposure), 0.0, 1.0)
    x = clip(F.apply_saturation(x, params.saturation), 0.0, 1.0)
    return _table_curve(_table_curve(x, params.tone), params.color)


def two_pass_pointwise_chain(image: torch.Tensor, params: FilterParams,
                             pixels_per_block: int = PIXELS_PER_BLOCK) -> torch.Tensor:
    """The kernel's two passes in plain PyTorch. Pass 1: the prefix, and one
    ITU-601 gray sum per block of ``pixels_per_block`` pixels of each image
    (in row-major pixel order; the last block of an image may be short).
    Pass 2: the image's mean from its partial sums, the prefix recomputed
    from the input, and the contrast around the mean."""
    b, h, w, _ = image.shape
    gray = C.rgb_to_gray(_prefix(image, params)).reshape(b, h * w)
    blocks = -(-(h * w) // pixels_per_block)
    padded = torch.nn.functional.pad(gray, (0, blocks * pixels_per_block - h * w))
    partials = padded.reshape(b, blocks, pixels_per_block).sum(dim=-1)
    mean = (partials.sum(dim=1) / (h * w)).reshape(b, 1, 1, 1)
    contrast = torch.where(params.contrast < 0, 0.0, params.contrast)
    return clip((_prefix(image, params) - mean) * contrast + mean, 0.0, 1.0)


def check_kernel_input(image: torch.Tensor) -> None:
    """What the kernel takes, checked before a launch: a contiguous float32
    (B, H, W, 3) tensor that int32 offsets can index."""
    if image.dtype != torch.float32:
        raise TypeError(f"pointwise_chain kernel takes float32, got {image.dtype}")
    if not image.is_contiguous():
        raise ValueError("pointwise_chain kernel takes a contiguous NHWC tensor")
    if image.shape[1] * image.shape[2] * 3 >= 2 ** 31 or image.shape[0] > 65535:
        raise ValueError("pointwise_chain kernel indexes an image with int32: image too large")


def pointwise_chain(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    """exposure -> saturation -> tone -> color -> contrast on (B, H, W, 3) f32
    in [0, 1], one ``FilterParams`` (scalar fields) for the whole batch."""
    if image.ndim != 4 or image.shape[-1] != 3:
        raise ValueError(f"pointwise_chain takes (B, H, W, 3), got {tuple(image.shape)}")
    if (params.exposure.ndim != 0 or params.tone.shape != (CURVE_KNOTS, 1)
            or params.color.shape != (CURVE_KNOTS, 3)):
        raise ValueError("pointwise_chain takes one parameter set (scalar fields)")
    if image.device.type == "cpu":
        return two_pass_pointwise_chain(image, params)
    if image.device.type != "cuda":
        raise ValueError(f"pointwise_chain: unsupported device {image.device}")
    check_kernel_input(image)
    return _launch(image, params)


# ---------------------------------------------------------------------------
# The CUDA kernel through ctypes
# ---------------------------------------------------------------------------

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_PTR, _PTR, _PTR, _LL, _INT, _INT, _PTR, _PTR, _PTR, _LL, _PTR, _LL, _LL, _PTR,
             _PTR]


@functools.cache
def kernel_function():
    """The C entry point ``rgie_pointwise_chain`` of ``csrc/pointwise_chain.cu``,
    built if needed, with its argument types set."""
    fn = build.load_library(KERNEL_SOURCE).rgie_pointwise_chain
    fn.argtypes, fn.restype = _ARGTYPES, _INT
    return fn


def launch(fn, image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    """Both passes of ``fn`` (a ``rgie_pointwise_chain`` entry point) on a
    checked CUDA tensor, on the current stream. The parameters are read in
    place where they are float32 on the image's device (the re-render's are
    views of its parameter vector), else copied there first."""
    b, h, w, _ = image.shape
    index = image.get_device()
    fields = (params.exposure, params.saturation, params.contrast, params.tone, params.color)
    if any(t.dtype != torch.float32 or t.get_device() != index for t in fields):
        fields = tuple(t.to(image.device, torch.float32) for t in fields)
    exposure, saturation, contrast, tone, color = fields
    out = torch.empty_like(image)
    partials = torch.empty(b * -(-(h * w) // PIXELS_PER_BLOCK), dtype=torch.float32,
                           device=image.device)
    # The raw stream handle: torch.cuda.current_stream() would build a Stream
    # object, a few microseconds of a call whose device time is tens of them.
    status = fn(image.data_ptr(), out.data_ptr(), partials.data_ptr(), partials.numel(), b,
                h * w, exposure.data_ptr(), saturation.data_ptr(), tone.data_ptr(),
                tone.stride(0), color.data_ptr(), color.stride(0), color.stride(1),
                contrast.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    if status != 0:
        raise RuntimeError(f"pointwise_chain: launch failed with CUDA error {status}"
                           if status > 0 else "pointwise_chain: shape not taken by the kernel")
    return out


def _launch(image: torch.Tensor, params: FilterParams) -> torch.Tensor:
    global LAUNCHES
    out = launch(kernel_function(), image, params)
    LAUNCHES += 1
    return out
