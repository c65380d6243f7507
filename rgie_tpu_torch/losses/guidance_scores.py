"""Guidance score functions on latent-space regressor outputs. Port of
``rgie_tpu/losses/guidance_scores.py`` (reference:
``src/guidance_classifier/guidance_scores.py``).

Targets: explicit ``reference_value``, else the untargeted defaults:
minimize -> (valence 0.5, arousal 0.0); maximize -> (1.0, 1.0).
"""

from __future__ import annotations

from typing import Optional

import torch


def _target(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def valence_arousal_score(predicted_va: torch.Tensor, is_minimized: bool = True,
                          reference_value=None) -> torch.Tensor:
    """Sum of squared errors to the VA target (guidance_scores.py:4-22)."""
    if reference_value is not None:
        target = _target(reference_value, predicted_va)
    else:
        target = _target((0.5, 0.0) if is_minimized else (1.0, 1.0), predicted_va)
    err = target.expand(predicted_va.shape) - predicted_va
    return torch.sum(err * err)


def _column(predicted: torch.Tensor, index: int) -> torch.Tensor:
    if predicted.ndim > 1 and predicted.shape[1] > 1:
        return predicted[:, index]
    return predicted.reshape(-1)


def valence_score(predicted: torch.Tensor, is_minimized: bool = True,
                  reference_value: Optional[float] = None) -> torch.Tensor:
    """Squared error on the valence column (guidance_scores.py:49-73)."""
    pred = _column(predicted, 0)
    target = _target(reference_value if reference_value is not None
                     else (0.5 if is_minimized else 1.0), pred)
    err = (target - pred).squeeze()
    return err * err


def arousal_score(predicted: torch.Tensor, is_minimized: bool = True,
                  reference_value: Optional[float] = None) -> torch.Tensor:
    """Squared error on the arousal column (guidance_scores.py:25-46)."""
    pred = _column(predicted, 1)
    target = _target(reference_value if reference_value is not None
                     else (0.0 if is_minimized else 1.0), pred)
    err = (target - pred).squeeze()
    return err * err
