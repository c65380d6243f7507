"""Teacher labeler: the pixel-space VA regressor as the label source for
guidance-regressor training. Port of ``rgie_tpu/training/clf_wrapper.py``.

Reference: ``src/clf/ClfWrapper.py`` wraps ValenceArousalLoss and exposes
``get_label(images)``; used when the training dataset has no VA annotations
(train_guidance_clf.py:127,237).
"""

from __future__ import annotations

import dataclasses

import torch

from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss


@dataclasses.dataclass(frozen=True)
class ClfWrapper:
    """get_label(images) -> (B, D) teacher labels without gradient
    (ClfWrapper.py:33-41). ``images`` NHWC in [0, 1] (a normalize=True
    regressor) or [-1, 1]."""

    loss: ValenceArousalLoss

    @torch.no_grad()
    def get_label(self, images: torch.Tensor) -> torch.Tensor:
        return self.loss.predict_loss_metric(images)

    @property
    def num_outputs(self) -> int:
        return len(self.loss.output_ixs)


def create_teacher(generator: torch.Generator, loss_type: str = "va", normalize: bool = True,
                   **regressor_kwargs) -> ClfWrapper:
    """A random-weight teacher drawn from ``generator``."""
    from rgie_tpu_torch.models.emotion import create_regressor

    reg = create_regressor(generator, normalize=normalize, **regressor_kwargs)
    return ClfWrapper(loss=ValenceArousalLoss(regressor=reg, loss_type=loss_type))
