"""Compound emotion vector (polarity, theta, intensity) from an 8-emotion
distribution, on tensors (port of ``rgie_tpu/losses/compound.py``).

Reference: ``src/baselines/losses/CompoundEmotionVector.py`` ("A
Circular-Structured Representation for Visual Emotion Distribution
Learning"). Column order: Amusement Awe Contentment Excitement Anger Disgust
Fear Sadness.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

# Angles of the 8 basic emotions (CompoundEmotionVector.py:6).
EMOTION_ANGLES = tuple(a * 0.125 * math.pi for a in (11.0, 7.0, 9.0, 5.0, 13.0, 15.0, 3.0, 1.0))


class CompoundEmotion(NamedTuple):
    polarity: torch.Tensor
    theta: torch.Tensor
    intensity: torch.Tensor


def compute_compound_emotion_vector(emotions: torch.Tensor,
                                    emo_type: Optional[torch.Tensor] = None) -> CompoundEmotion:
    """(B, 8) distribution -> (polarity, theta, intensity)
    (CompoundEmotionVector.py:65-85)."""
    angles = (torch.tensor(EMOTION_ANGLES, dtype=emotions.dtype, device=emotions.device)
              if emo_type is None else emo_type)
    ex = torch.sum(emotions * torch.cos(angles), dim=1)
    ey = torch.sum(emotions * torch.sin(angles), dim=1)
    intensity = torch.sqrt(ex * ex + ey * ey)
    theta_atan2 = torch.atan2(ey, ex)
    theta = torch.remainder(theta_atan2, 2 * math.pi)
    polarity = (torch.abs(theta_atan2) > math.pi / 2.0).to(emotions.dtype)
    return CompoundEmotion(polarity=polarity, theta=theta, intensity=intensity)


def from_vector_or_distribution(emotions: torch.Tensor,
                                emo_type: Optional[torch.Tensor] = None) -> CompoundEmotion:
    """(B, 3) explicit (polarity, theta, intensity) or (B, 8) distribution
    (CompoundEmotionVector.py:50-63)."""
    if emotions.shape[1] == 3:
        return CompoundEmotion(emotions[:, 0], emotions[:, 1], emotions[:, 2])
    return compute_compound_emotion_vector(emotions, emo_type)
