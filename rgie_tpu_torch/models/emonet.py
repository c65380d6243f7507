"""EmoNet: the alternate valence-only ResNet-50 regressor. Port of
``rgie_tpu/models/emonet.py``.

Reference: ``src/baselines/models/EmoNet.py``: ImageNet normalization
(0.485/0.456/0.406, 0.229/0.224/0.225), the classic ten-crop at 224 from a
256 resize (4 corners and the center, then each mirrored), and the output
padded with a fake arousal column (EmoNet.py:92-96). The reference's
checkpoint names the network ``<wrapper>.model.*`` with the head as
``last_linear``; ``from_reference_keys`` maps those names onto the
torchvision names of ``models/resnet.py`` (the JAX package's
``convert_emonet_checkpoint`` remap) and ``to_reference_keys`` is its
inverse.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from rgie_tpu_torch.models.init import freeze_, random_init_
from rgie_tpu_torch.models.resnet import ResNet, resnet50
from rgie_tpu_torch.ops import geometry as G
from rgie_tpu_torch.ops.numerics import clip

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def classic_ten_crop(images: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """Classic TenCrop (EmoNet.py:110-130): corners 0-3, the center 4, then
    the horizontal mirrors of the five. (B, S, S, C) -> (B * 10, crop, crop,
    C) in (image, crop) order. The center's offset is the reference's
    ``floor(m / 2) + 1`` (EmoNet.py:124)."""
    b, size = images.shape[0], images.shape[1]
    m = size - crop
    center = m // 2 + 1
    offsets = [(0, 0), (0, m), (m, 0), (m, m), (center, center)]
    crops = [images[:, y:y + crop, x:x + crop, :] for (y, x) in offsets]
    mirrored = [c.flip(2) for c in crops]
    return torch.stack(crops + mirrored, dim=1).reshape(b * 10, crop, crop, images.shape[-1])


class EmoNet(nn.Module):
    """Valence regressor pipeline: an optional [0, 1] -> [-1, 1]
    normalization, denormalization to [0, 1] and clip, a 256 antialiased
    resize, the classic ten-crop at 224, ImageNet normalization, ResNet-50
    with one output, the mean over crops, and a zero "fake arousal" column.
    Images NHWC; returns (B, 2)."""

    def __init__(self, net: ResNet, normalize_input: bool = False, num_classes: int = 2):
        super().__init__()
        self.net = net
        self.normalize_input = normalize_input
        self.num_classes = num_classes
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is accepted for the regressor call signature; the
        crops are fixed."""
        x = images
        if self.normalize_input:
            x = (x - 0.5) / 0.5                      # EmoNet.py:80-81
        x = clip((x + 1.0) / 2.0, 0.0, 1.0)          # EmoNet.py:88-90, /255 folded
        x = G.resize(x, (256, 256), antialias=True)
        x = classic_ten_crop(x, 224)
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        out = self.net(x.permute(0, 3, 1, 2))        # (B * 10, 1)
        out = out.reshape(-1, 10).mean(dim=1)
        return torch.stack([out, torch.zeros_like(out)], dim=1)


def from_reference_keys(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's names -> torchvision names
    (``convert_emonet_checkpoint``: drop the first component, then a
    ``model.`` prefix; ``last_linear`` is ``fc``)."""
    sd = {".".join(k.split(".")[1:]): v for k, v in state_dict.items()}
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}
    if "last_linear.weight" in sd:
        sd["fc.weight"] = sd.pop("last_linear.weight")
        sd["fc.bias"] = sd.pop("last_linear.bias")
    return sd


def to_reference_keys(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision names -> the reference checkpoint's (``module.model.*``,
    the head as ``last_linear``): the inverse of ``from_reference_keys``."""
    head = {"fc.weight": "last_linear.weight", "fc.bias": "last_linear.bias"}
    return {f"module.model.{head.get(k, k)}": v for k, v in state_dict.items()}


def load_emonet(state_dict: Mapping[str, torch.Tensor], normalize_input: bool = False) -> EmoNet:
    """A frozen EmoNet on the CPU from a checkpoint under the reference's
    names (``strict=True``)."""
    net = resnet50(1)
    net.load_state_dict(from_reference_keys(state_dict), strict=True)
    return freeze_(EmoNet(net, normalize_input=normalize_input))


def create_emonet(generator: torch.Generator, normalize_input: bool = False) -> EmoNet:
    """A frozen random-weight EmoNet on the CPU, drawn from ``generator``
    (stand-in for the external checkpoint)."""
    return freeze_(EmoNet(random_init_(resnet50(1), generator), normalize_input=normalize_input))
