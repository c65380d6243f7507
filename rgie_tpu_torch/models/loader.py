"""Model loading dispatch for the pixel-space VA loss. Port of
``rgie_tpu/models/loader.py``: the checkpoint PATH drives the architecture
(ValenceArousalLoss.py:29-57) — "EmoNet" gives the valence-only EmoNet
(``models/emonet.py``); otherwise ResNet-50 with 4 outputs + sigmoid,
changed by "no_sigmoid" (no sigmoid), "mse" (2 outputs, no sigmoid) and
"arousal_nll" (2 outputs). A missing checkpoint gives a random-weight
stand-in so the pipelines run without the external artifacts.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
from rgie_tpu_torch.models.emotion import EmotionRegressor, create_regressor
from rgie_tpu_torch.models.init import freeze_
from rgie_tpu_torch.models.resnet import resnet50
from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict


def load_va_loss(path_to_model: Optional[str], generator: torch.Generator,
                 weight: float = 1.0, loss_type: str = "va", is_minimized: bool = True,
                 is_input_range_0_1: bool = True, input_size: int = 480,
                 crop_size: int = 448) -> ValenceArousalLoss:
    """Build the VA loss (on the CPU) with the reference's path-name dispatch.
    A torchvision ``va_pred_all`` state dict loads with ``strict=True``."""
    path = str(path_to_model) if path_to_model else ""
    exists = bool(path) and os.path.exists(path)
    if "EmoNet" in path:
        from rgie_tpu_torch.models.emonet import create_emonet, load_emonet

        if exists:
            net = load_emonet(load_torch_state_dict(path), normalize_input=is_input_range_0_1)
        else:
            net = create_emonet(generator, normalize_input=is_input_range_0_1)
        # Output (valence, fake arousal) (EmoNet.py:92-96): a valence loss.
        return ValenceArousalLoss(regressor=net, weight=weight, loss_type="valence",
                                  is_minimized=is_minimized)

    num_classes = 4
    use_sigmoid = True
    if "no_sigmoid" in path:
        use_sigmoid = False
    if "mse" in path:
        num_classes = 2
        use_sigmoid = False
    if "arousal_nll" in path:
        num_classes = 2

    kw = dict(num_classes=num_classes, normalize=is_input_range_0_1,
              input_size=input_size, crop_size=crop_size, use_sigmoid=use_sigmoid)
    if exists:
        net = resnet50(num_classes)
        net.load_state_dict(load_torch_state_dict(path), strict=True)
        regressor = freeze_(EmotionRegressor(net, **kw))
    else:
        regressor = create_regressor(generator, **kw)
        if path:
            print(f"WARNING: {path} not found; random-weight regressor stand-in")
    return ValenceArousalLoss(regressor=regressor, weight=weight,
                              loss_type=loss_type, is_minimized=is_minimized)
