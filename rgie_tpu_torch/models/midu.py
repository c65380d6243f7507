"""Midu guidance classifiers: small CNNs reading UNet mid-block activations.
Port of ``rgie_tpu/models/midu.py`` (reference:
``src/guidance_classifier/MiduClassifier.py:122-161``).

Both variants are ``nn.Sequential``s with the reference's layer indices, so
its checkpoints load with ``strict=True``. They take the UNet's mid-block
features NHWC, as the UNet returns them, and run NCHW inside (the first
linear layer sees torch's channel-major flatten, as in the checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from rgie_tpu_torch.losses.guidance_scores import valence_arousal_score
from rgie_tpu_torch.models.init import freeze_, random_init_


class _FeatureSequential(nn.Sequential):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2))


class MiduSDXL(_FeatureSequential):
    """SDXL variant (MiduClassifier.py:124-143): 4x(conv3x3 + relu + maxpool)
    1280->512->256->128->64, flatten 64*2*2, linear 256->128->out. Expects
    (B, 32, 32, 1280) mid-block features. Convs at 0, 3, 6, 9; linears at 13,
    15."""

    def __init__(self, num_outputs: int = 2, in_channels: int = 1280):
        layers, ch = [], in_channels
        for out in (512, 256, 128, 64):
            layers += [nn.Conv2d(ch, out, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2)]
            ch = out
        layers += [nn.Flatten(), nn.Linear(256, 128), nn.ReLU(), nn.Linear(128, num_outputs)]
        super().__init__(*layers)


class MiduSD(_FeatureSequential):
    """SD variant (MiduClassifier.py:144-160): conv 1280->256 + pool, conv
    256->128, adaptive-avg-pool to 2x2, linear 512->64->out. Expects (B, 8,
    8, 1280) or (B, 16, 16, 1280) features. Convs at 0, 3; linears at 7, 9."""

    def __init__(self, num_outputs: int = 2, in_channels: int = 1280):
        super().__init__(
            nn.Conv2d(in_channels, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(256, 128, 3, padding=1), nn.ReLU(), nn.AdaptiveAvgPool2d((2, 2)),
            nn.Flatten(), nn.Linear(512, 64), nn.ReLU(), nn.Linear(64, num_outputs))


def create_midu(generator: torch.Generator, is_sdxl: bool = False, num_outputs: int = 2,
                in_channels: int = 1280) -> nn.Module:
    """A frozen random-weight midu model on the CPU, drawn from ``generator``."""
    model = (MiduSDXL if is_sdxl else MiduSD)(num_outputs, in_channels)
    return freeze_(random_init_(model, generator))


@dataclasses.dataclass(frozen=True)
class ValenceArousalMidu:
    """VA scoring head over midu outputs (reference:
    ``src/guidance_classifier/ValenceArousalMidu.py``: num_outputs=2; the loss
    is the squared error to the VA target, guidance_scores.py:4-22).

    ``features`` are the UNet mid-block activations, upcast to float32 (the
    reference always upcasts, MiduClassifier.py:49)."""

    model: nn.Module
    is_minimized: bool = True
    reference_value: Optional[torch.Tensor] = None

    def predict(self, features: torch.Tensor) -> torch.Tensor:
        return self.model(features.float())

    def score(self, features: torch.Tensor) -> torch.Tensor:
        """Guidance loss used inside classifier guidance (MiduClassifier.forward)."""
        return valence_arousal_score(self.predict(features), self.is_minimized,
                                     self.reference_value)

    def loss_and_outputs(self, features: torch.Tensor, labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training objective (MiduClassifier.get_loss:52-64): MSE vs labels."""
        outputs = self.predict(features)
        return torch.mean((outputs - labels) ** 2), outputs
