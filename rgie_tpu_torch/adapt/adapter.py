"""Diffusion editing of one image. Port of ``rgie_tpu/adapt/adapter.py``
(reference package ``src/adapt_images/``: adapter.py, scoring.py, plus the
``revert_and_sample`` loop of
``src/pipelines/InversionResamplingDiffusionPipeline.py:74-122``): the VA
scorer, and the edit of one image over one or more guidance settings:
DDIM-invert, optionally run the null-text optimization (recomputed only when
the CFG scale changes), sample per guidance setting and decode.

The dataset loop of the JAX package's ``ImageAdapter.adapt`` and its
``OutputImageManager`` (save and rescore each output) are not here: the
port's CLI runs every batch size, one image too, through the batched program
(``diffusion/batched.py``), which scores the original and the edit itself,
and writes each image's outputs (``cli/adapt_images.py``).

As in the JAX package, the shared GuidanceConfig's reference_value is NOT
mutated in place (the reference compounds the alpha offset from image 2
onward, adapter.py:33-36), and pivot latents are per-call outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from rgie_tpu_torch.config import GuidanceConfig
from rgie_tpu_torch.diffusion.pipeline import (InversionResamplingPipeline, PhaseClock, RunLog,
                                               SdxlCond)
from rgie_tpu_torch.utils.stats import print_score


def cond_row(both: SdxlCond, row: int) -> SdxlCond:
    return SdxlCond(both.text_embeds[row:row + 1], both.time_ids[row:row + 1])


@dataclasses.dataclass
class ImageScorer:
    """VA scoring through the latent-space midu classifier
    (reference: src/adapt_images/scoring.py:7-24)."""

    pipe: InversionResamplingPipeline
    embeds_fn: Callable[[str, str], torch.Tensor]  # (prompt, negative) -> (1, L, D)
    added_cond_fn: Optional[Callable[[str, str], SdxlCond]] = None  # SDXL

    def __post_init__(self):
        self._empty = self.embeds_fn("", "")
        self._added = None
        if self.pipe.is_xl and self.added_cond_fn is not None:
            self._added = cond_row(self.added_cond_fn("", ""), 1)

    def score(self, image: torch.Tensor) -> np.ndarray:
        """(1, H, W, 3) in [0,1] (already transform_image'd) -> (1, 2) VA."""
        return self.pipe.score(image, self._empty, self._added).cpu().numpy()

    def rec_error(self, orig: torch.Tensor, adapted: torch.Tensor) -> float:
        return float(torch.mean(torch.abs(adapted - orig)))

    print_score = staticmethod(print_score)


def transform_image(image_hwc: np.ndarray, input_size: int) -> torch.Tensor:
    """Resize(shorter)+CenterCrop+ToTensor (pipeline transform,
    InversionResamplingDiffusionPipeline.py:23-27), NHWC [0,1], on the CPU."""
    from rgie_tpu_torch.data.dataset import preprocess_image

    return torch.from_numpy(preprocess_image(image_hwc, input_size, input_size))


@dataclasses.dataclass
class ImageAdapter:
    """The prompt encoders of an edit and the single-image edit
    (``revert_and_sample``, InversionResamplingDiffusionPipeline.py:74-122).
    ``last_log`` holds the ``RunLog`` of the latest ``revert_and_sample``."""

    pipe: InversionResamplingPipeline
    scorer: ImageScorer
    embeds_fn: Callable[[str, str], torch.Tensor]       # single-prompt embeds
    cfg_embeds_fn: Callable[[str, str], torch.Tensor]   # (2, L, D) [uncond; cond]
    # SDXL only: (prompt, negative) -> SdxlCond with rows [uncond; cond]
    # (text_embeds + micro-conditioning time_ids, diff_utils.py:274-367).
    added_cond_fn: Optional[Callable[[str, str], SdxlCond]] = None
    last_log: Optional[RunLog] = None

    def revert_and_sample(self, image: torch.Tensor, caption: str,
                          end_iteration: Optional[int],
                          configs: Dict[str, GuidanceConfig],
                          reference_value=None,
                          callback_outputs=None) -> Dict[str, torch.Tensor]:
        pipe = self.pipe
        log = self.last_log = RunLog()
        clock = PhaseClock(pipe.device, log)
        s = pipe.sched.num_inference_steps
        end_it = end_iteration if end_iteration is not None else s
        start_iteration = 0 if s != pipe.sched.num_inference_steps else s - end_it

        # Null-text inversion uses empty prompts (pipeline.py:83-84).
        empty = self.embeds_fn("", "")
        added_empty = None
        if pipe.is_xl and self.added_cond_fn is not None:
            added_empty = cond_row(self.added_cond_fn("", ""), 1)
        latents = pipe.encode_image(image)
        clock.lap("encode")
        noisy, pivots = pipe.reverse_sample(latents, empty, added=added_empty,
                                            end_iteration=end_it)
        clock.lap("invert")
        log.tensors.update(latents=latents, noisy=noisy)

        outputs: Dict[str, torch.Tensor] = {}
        nto_embeds = None
        nto_scale = -1.0
        for key, cfg in configs.items():
            prompt = cfg.prompt if not cfg.use_caption else (caption + " " + cfg.prompt)
            if cfg.is_nto and nto_scale != cfg.cfg_scale:
                nto_scale = cfg.cfg_scale
                cond = self.embeds_fn(caption, "")
                uncond = self.embeds_fn("", "")
                nto_added_c, nto_added_u = None, None
                if pipe.is_xl and self.added_cond_fn is not None:
                    both = self.added_cond_fn(caption, "")
                    nto_added_u, nto_added_c = cond_row(both, 0), cond_row(both, 1)
                clock.lap("prompts")
                nto_embeds = pipe.null_optimization(
                    pivots, cond, uncond, added_cond=nto_added_c, added_uncond=nto_added_u,
                    guidance_scale=cfg.cfg_scale, log=log)
                clock.lap("nto")
                log.tensors["nto_embeds"] = nto_embeds
            elif not cfg.is_nto:
                nto_embeds = None
                nto_scale = -1.0

            embeds = self.cfg_embeds_fn(prompt, cfg.negative_prompt)
            added = None
            if pipe.is_xl and self.added_cond_fn is not None:
                added = self.added_cond_fn(prompt, cfg.negative_prompt)
            clock.lap("prompts")
            out_lat = pipe.sample(
                noisy, embeds, added=added, guidance_scale=cfg.cfg_scale,
                guidance_clf_scale=cfg.clf_scale, uncond_embeds_per_step=nto_embeds,
                start_iteration=start_iteration, midu_is_minimized=not cfg.max,
                midu_reference_value=reference_value, log=log)
            clock.lap("sample")
            img = pipe.decode_latents(out_lat)
            clock.lap("decode")
            log.tensors["out_latents"] = out_lat
            outputs[key] = img
            if callback_outputs is not None:
                callback_outputs(img, key)
                clock.lap("save_and_rescore")
        return outputs

