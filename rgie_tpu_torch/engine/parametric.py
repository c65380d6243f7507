"""End-to-end parametric pixel-space editing. Port of
``rgie_tpu/engine/parametric.py`` (reference entry point:
src/optimize_image_param.py).

Each Adam step: filter chain -> frozen VA regressor (fwd + bwd) -> frozen
CLIP (fwd + bwd) -> Adam update, for a batch of images at once with a
``(B, 41)`` parameter tensor and per-image losses.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rgie_tpu.config import ParamEditConfig
from rgie_tpu_torch.engine.optimize import OptResult, optimize
from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
from rgie_tpu_torch.models.clip import ClipImageEncoder, clip_loss
from rgie_tpu_torch.models.discriminators import PixelDiscriminator
from rgie_tpu_torch.ops import chain as CH
from rgie_tpu_torch.ops.numerics import clip, maximum


class EditModels(NamedTuple):
    """The frozen modules of the objective (the JAX package passes their
    weights as a pytree; here the modules themselves)."""

    va_loss: ValenceArousalLoss
    clip: Optional[ClipImageEncoder] = None
    dis: Optional[PixelDiscriminator] = None


class EditContext(NamedTuple):
    """Per-image constants of the objective."""

    image: torch.Tensor          # (B, H, W, 3) in [0, 1]
    target: torch.Tensor         # (B, D) VA target from alpha
    clip_features: torch.Tensor  # (B, 512) normalized features of the originals


def discriminator_realism_loss(dis: PixelDiscriminator, edited: torch.Tensor) -> torch.Tensor:
    """BCE(dis(edited), real) per image, (B,) — the NetWithCriterion term
    (optimize_image_param.py:315-330, label 1.0, nn.BCELoss on the sigmoid
    multi-scale prediction; BCELoss clamps the log at -100).

    Divergence from the reference, kept from the JAX package: the reference
    computes ``loss -= weight_dis * dis(image)`` on the UNEDITED input
    (objective_function_parametric:245-247), a constant with respect to the
    optimized vector with an inverted sign. The evident intent of
    NetWithCriterion(label=1.0) is a realism regularizer on the edit, so the
    EDITED image is scored and the BCE-to-real term is ADDED."""
    p = dis(edited)
    return -torch.mean(maximum(torch.log(p), -100.0), dim=-1)


def make_objective(models: EditModels, cfg: ParamEditConfig
                   ) -> Callable[[torch.Tensor, EditContext], torch.Tensor]:
    """objective(x (B, 41), ctx) -> per-image losses (B,)
    (objective_function_parametric, optimize_image_param.py:237-259)."""
    use_dis = models.dis is not None and cfg.weight_dis > 0
    use_clip = models.clip is not None and cfg.weight_recon > 0

    def objective(x: torch.Tensor, ctx: EditContext) -> torch.Tensor:
        out = CH.edit_image(ctx.image, x, input_size=cfg.crop_size, order=cfg.transforms)
        loss = cfg.weight_clf * models.va_loss.per_image(out, target=ctx.target)
        if use_dis:
            loss = loss + cfg.weight_dis * discriminator_realism_loss(models.dis, out)
        if use_clip:
            loss = loss + cfg.weight_recon * clip_loss(models.clip, ctx.clip_features, out)
        return loss

    if cfg.remat:
        # Recompute the frozen-model forwards during the backward pass instead
        # of keeping the ten-crop ResNet/CLIP activations.
        return lambda x, ctx: checkpoint(objective, x, ctx, use_reentrant=False)
    return objective


@torch.no_grad()
def make_context(models: EditModels, cfg: ParamEditConfig, images: torch.Tensor,
                 alphas: torch.Tensor) -> EditContext:
    """Relative targets clamp(VA(original) + alpha, 0, 1) (optimize_image.py:
    119-123) and the originals' CLIP features, without gradient."""
    target = clip(models.va_loss.predict_loss_metric(images) + alphas, 0.0, 1.0)
    if models.clip is not None and cfg.weight_recon > 0:
        feats = models.clip.embed_normalized(images)
    else:
        feats = images.new_zeros((images.shape[0], 1))
    return EditContext(image=images, target=target, clip_features=feats)


def make_batched_edit(models: EditModels, cfg: ParamEditConfig
                      ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[OptResult, torch.Tensor]]:
    """edit(images (B, H, W, 3), alphas (B, 2)) -> (OptResult, edited).
    Every image is edited independently from the identity vector, all B in
    lockstep (the reference loops one image at a time)."""
    objective = make_objective(models, cfg)

    def edit(images: torch.Tensor, alphas: torch.Tensor) -> Tuple[OptResult, torch.Tensor]:
        ctx = make_context(models, cfg, images, alphas)
        x0 = CH.pack_params(CH.init_params(images.dtype, images.device))
        x0 = x0.expand(images.shape[0], -1)
        result = optimize(lambda x: objective(x, ctx), x0, cfg.optimize)
        with torch.no_grad():
            edited = CH.edit_image(images, result.best_x, input_size=cfg.crop_size,
                                   order=cfg.transforms)
        return result, edited

    return edit


def make_evaluate(va_loss: ValenceArousalLoss) -> Callable[[torch.Tensor, torch.Tensor], dict]:
    """compare_emotions analog (run_img_trans.py:361-386): VA before/after,
    delta and the L1 reconstruction error, per image."""

    @torch.no_grad()
    def evaluate(image: torch.Tensor, edited: torch.Tensor) -> dict:
        va_orig = va_loss.predict_loss_metric(image)
        va_adapted = va_loss.predict_loss_metric(edited)
        return {
            "va_original": va_orig,
            "va_adapted": va_adapted,
            "va_delta": va_adapted - va_orig,
            "rec_error": torch.mean(torch.abs(edited - image), dim=(1, 2, 3)),
        }

    return evaluate
