"""Valence/arousal losses on the pixel-space regressor. Port of
``rgie_tpu/losses/emotion_loss.py`` (reference: ValenceArousalLoss.py,
EmotionImageLoss.py): targets are explicit arguments, and ``per_image``
gives one loss per image for the batched edit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from rgie_tpu_torch.models.emotion import EmotionRegressor
from rgie_tpu_torch.ops.numerics import clip

# Regressor output columns: valence mean 0, arousal mean 1 (ValenceArousalLoss.py:51).
OUTPUT_IXS = {"va": (0, 1), "valence": (0,), "arousal": (1,)}


def default_target(loss_type: str, is_minimized: bool, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Untargeted defaults: minimize -> valence 0.5 / arousal 0.0; maximize ->
    1.0 / 1.0 (ValenceArousalLoss.py:87,106)."""
    valence = 0.5 if is_minimized else 1.0
    arousal = 0.0 if is_minimized else 1.0
    values = {"valence": [valence], "arousal": [arousal]}.get(loss_type, [valence, arousal])
    return torch.tensor(values, dtype=dtype, device=device)


class ValenceArousalLoss(nn.Module):
    """loss(images, target) = mean over the batch of weight * sum over the
    selected VA components of (target - predicted)^2."""

    def __init__(self, regressor: EmotionRegressor, weight: float = 1.0,
                 loss_type: str = "va", is_minimized: bool = True):
        super().__init__()
        self.regressor = regressor
        self.weight = weight
        self.loss_type = loss_type
        self.is_minimized = is_minimized

    @property
    def output_ixs(self) -> Tuple[int, ...]:
        return OUTPUT_IXS[self.loss_type]

    def predict_loss_metric(self, images: torch.Tensor,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) -> (B, len(output_ixs)) predicted VA."""
        return self.regressor(images, generator=generator)[:, list(self.output_ixs)]

    def per_image(self, images: torch.Tensor, target: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B,) weight * sum((target - predicted)^2) per image."""
        predicted = self.predict_loss_metric(images, generator=generator)
        if target is None:
            target = default_target(self.loss_type, self.is_minimized,
                                    predicted.dtype, predicted.device).expand_as(predicted)
        err = target - predicted
        return self.weight * torch.sum(err * err, dim=-1)

    def forward(self, images: torch.Tensor, target: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.mean(self.per_image(images, target, generator))


@torch.no_grad()
def condition_from_alpha(loss: ValenceArousalLoss, image: torch.Tensor, alpha,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Relative target clamp(VA(original) + alpha, 0, 1), computed once per
    image without gradient (optimize_image.py:119-123)."""
    return clip(loss.predict_loss_metric(image, generator=generator) + alpha, 0.0, 1.0)
