"""Offline VA prediction over saved images. Port of
``rgie_tpu/analysis/predict_va.py``.

Reference: ``src/analysis/predict_valence_arousal.py`` and
``classifier_score_of_images.py`` (a lazily built pixel regressor, transform
Resize(480) + CenterCrop(448) + 0.5-normalize). Here the regressor is the
port's ten-crop ResNet-50 pipeline, built once per (model id, checkpoint,
device) and kept; the images are scored in one batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss

_MODELS: Dict[Tuple[str, Optional[str], str], ValenceArousalLoss] = {}


def _build(model_id: str, model_path: Optional[str], seed: int = 0) -> ValenceArousalLoss:
    """The VA loss on [-1, 1] images, on the CPU: the checkpoint's ResNet-50,
    or random weights from ``seed``. As in the JAX package, ``model_id ==
    "emonet"`` selects the valence column of the same ResNet-50 regressor
    (predict_va.py:33-35), not the EmoNet model."""
    from rgie_tpu_torch.models.emotion import EmotionRegressor, create_regressor
    from rgie_tpu_torch.models.init import freeze_
    from rgie_tpu_torch.models.resnet import resnet50
    from rgie_tpu_torch.utils.checkpoint import load_torch_state_dict

    if model_path is not None:
        net = resnet50(4)
        net.load_state_dict(load_torch_state_dict(model_path), strict=True)
        regressor = freeze_(EmotionRegressor(net, normalize=False))
    else:
        regressor = create_regressor(torch.Generator().manual_seed(seed), normalize=False)
    loss_type = "valence" if model_id == "emonet" else "va"
    return ValenceArousalLoss(regressor=regressor, loss_type=loss_type)


def scoring_model(model_id: str = "va", model_path: Optional[str] = None,
                  device="cuda") -> ValenceArousalLoss:
    """The kept VA loss of (model id, checkpoint) on ``device``, built at the
    first call."""
    from rgie_tpu_torch.device import resolve_device

    device = resolve_device(str(device))
    key = (model_id, model_path, str(device))
    if key not in _MODELS:
        _MODELS[key] = _build(model_id, model_path).to(device)
    return _MODELS[key]


@torch.no_grad()
def get_classifier_score_of_images(image_paths: Sequence[str], model_id: str = "va",
                                   model_path: Optional[str] = None,
                                   device="cuda") -> np.ndarray:
    """Paths -> (N, 2) VA predictions ((N, 1) for ``model_id="emonet"``;
    classifier_score_of_images.py:13-35). The images get the regressor
    transform (480/448, [-1, 1]) on the host; the ten-crop and the ResNet run
    on ``device``."""
    from rgie_tpu_torch.data.dataset import load_image_rgb, preprocess_image

    loss = scoring_model(model_id, model_path, device)
    batch = np.concatenate([preprocess_image(load_image_rgb(p), 480, 448, normalize=True)
                            for p in image_paths])
    device = next(loss.parameters()).device
    return loss.predict_loss_metric(torch.from_numpy(batch).to(device)).cpu().numpy()


def predict_valence_arousal(image_path: str, model_path: Optional[str] = None,
                            device="cuda") -> np.ndarray:
    """Single-image VA (predict_valence_arousal.py:12-27)."""
    return get_classifier_score_of_images([image_path], "va", model_path, device)[0]
