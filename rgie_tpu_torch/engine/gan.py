"""MUNIT style-code editing end to end. Port of ``rgie_tpu/engine/gan.py``
(reference entry point: src/optimize_image_imaginaire.py).

Adam optimizes the 8-dim style code of a frozen MUNIT autoencoder so that
the decoded image reaches a VA target, while an L1 term on a second content
encoding keeps the content. Images are NHWC in [-1, 1].

The JAX package ``vmap``s a single-image edit; here a batch of B images is
one ``(B, 8)`` style tensor, and every term of the objective is computed per
image, so one image's loss never depends on another's: the L1 mean, the
discriminator term (its ``-mean`` of the logits and its top-k) and the VA
loss each return ``(B,)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rgie_tpu_torch.config import GanEditConfig
from rgie_tpu_torch.engine.optimize import OptResult, optimize
from rgie_tpu_torch.losses.emotion_loss import ValenceArousalLoss
from rgie_tpu_torch.losses.gan import gan_loss
from rgie_tpu_torch.models.discriminators import MultiResPatchDiscriminator
from rgie_tpu_torch.models.munit import AutoEncoder
from rgie_tpu_torch.ops.numerics import absolute, clip


class GanEditModels(NamedTuple):
    """The frozen modules of the objective."""

    generator: AutoEncoder                             # domain a of net_G
    va_loss: ValenceArousalLoss
    dis: Optional[MultiResPatchDiscriminator] = None   # discriminator_a of net_D


class GanEditContext(NamedTuple):
    """Per-image constants of the objective."""

    content: torch.Tensor   # (B, h, w, C) frozen content codes
    target: torch.Tensor    # (B, D) VA targets


def discriminator_term(dis: MultiResPatchDiscriminator, images: torch.Tensor) -> torch.Tensor:
    """relu(-gan_loss(dis(image), real, generator update)) per image, (B,)
    (optimize_image_imaginaire.py:132-137, the formula as written: with the
    hinge generator loss -mean(logits) it is relu(mean(logits)))."""
    outs, _, _ = dis(images)
    losses = [gan_loss([o[b:b + 1] for o in outs], True, gan_mode="hinge", dis_update=False)
              for b in range(images.shape[0])]
    return F.relu(-torch.stack(losses))


def make_objective(models: GanEditModels, cfg: GanEditConfig
                   ) -> Callable[[torch.Tensor, GanEditContext], torch.Tensor]:
    """objective(style (B, 8), ctx) -> per-image losses (B,)
    (objective_function_imaginaire, optimize_image_imaginaire.py:120-145):
    the VA loss of the clamped decode, plus the discriminator term when
    ``weight_dis > 0`` and a discriminator is given, plus the L1 content
    reconstruction."""
    gen = models.generator
    use_dis = models.dis is not None and cfg.weight_dis > 0

    def objective(style: torch.Tensor, ctx: GanEditContext) -> torch.Tensor:
        img = clip(gen.decode(ctx.content, style), -1.0, 1.0)
        loss = cfg.weight_clf * models.va_loss.per_image(img, target=ctx.target)
        if use_dis:
            loss = loss + cfg.weight_dis * discriminator_term(models.dis, img)
        if cfg.weight_recon > 0:
            content_new = gen.encode_content(img)
            loss = loss + cfg.weight_recon * torch.mean(absolute(content_new - ctx.content),
                                                        dim=(1, 2, 3))
        return loss

    if cfg.remat:
        # Recompute decoder, regressor and encoder activations during the
        # backward pass instead of keeping them (1024 px headroom).
        return lambda style, ctx: checkpoint(objective, style, ctx, use_reentrant=False)
    return objective


@torch.no_grad()
def make_context(models: GanEditModels, images: torch.Tensor, alphas: torch.Tensor
                 ) -> Tuple[GanEditContext, torch.Tensor]:
    """The frozen content codes, the initial styles and the relative targets
    clamp(VA(original) + alpha, 0, 1), without gradient
    (optimize_image_imaginaire.py:112-117)."""
    content, style0 = models.generator.encode(images)
    target = clip(models.va_loss.predict_loss_metric(images) + alphas, 0.0, 1.0)
    return GanEditContext(content=content, target=target), style0


def make_batched_edit(models: GanEditModels, cfg: GanEditConfig
                      ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[OptResult, torch.Tensor]]:
    """edit(images (B, H, W, 3) in [-1, 1], alphas (B, 2)) -> (OptResult,
    edited (B, H, W, 3) in [-1, 1]). Each image starts from its own style
    code; all B are edited in lockstep."""
    objective = make_objective(models, cfg)

    def edit(images: torch.Tensor, alphas: torch.Tensor) -> Tuple[OptResult, torch.Tensor]:
        ctx, style0 = make_context(models, images, alphas)
        result = optimize(lambda s: objective(s, ctx), style0, cfg.optimize)
        with torch.no_grad():
            edited = clip(models.generator.decode(ctx.content, result.best_x), -1.0, 1.0)
        return result, edited

    return edit


def make_single_edit(models: GanEditModels, cfg: GanEditConfig
                     ) -> Callable[[torch.Tensor, Sequence[float]], Tuple[OptResult, torch.Tensor]]:
    """edit(image (1, H, W, 3), alpha (2,)) -> (OptResult of one image,
    edited (1, H, W, 3))."""
    batched = make_batched_edit(models, cfg)

    def edit(image: torch.Tensor, alpha) -> Tuple[OptResult, torch.Tensor]:
        alphas = torch.as_tensor(alpha, dtype=image.dtype, device=image.device)[None]
        return batched(image, alphas)

    return edit


def to_unit_range(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] for saving (optimize_image_imaginaire.py:178-179)."""
    return (image + 1.0) * 0.5
