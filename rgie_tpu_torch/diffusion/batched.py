"""Batched diffusion editing: the whole edit of B images as one program.
Port of ``rgie_tpu/diffusion/batched.py``.

The reference edits one image at a time (``src/adapt_images.py:60-85``
iterates a bs=1 DataLoader; ``revert_and_sample``,
``src/pipelines/InversionResamplingDiffusionPipeline.py:74-122``). Here the
per-image program (VAE encode -> original VA score -> inversion -> null-text
optimization -> guided sampling -> VAE decode -> adapted VA rescore) runs
over a batch of images at once: every UNet and VAE call takes the B images
together, and each row equals the single-image edit of its image.

The JAX package ``vmap``s a single-image program; the port runs the
pipeline's loops on batched tensors instead, and keeps what ``vmap`` gives
each image: its own conditioning rows (the CFG pair is [latents; latents]
against B uncond rows, then B cond rows), its own reference value, its own
null-text early stop (``InversionResamplingPipeline.null_optimization_steps``)
and its own classifier-gradient normalization (``sample_steps``).

The per-image conditioning (the caption's prompt embeddings and SDXL's added
conds) comes as ``BatchedConds`` with a leading batch axis; the empty-prompt
embeddings of inversion and scoring are shared by the batch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from rgie_tpu_torch.diffusion import schedulers as SCH
from rgie_tpu_torch.diffusion.pipeline import (InversionResamplingPipeline, PhaseClock, RunLog,
                                               SdxlCond)
from rgie_tpu_torch.ops.kernels.flash_attention import MAX_BATCH_HEADS


class BatchedConds(NamedTuple):
    """Per-image conditioning, every leaf with a leading batch axis."""

    cfg_embeds: torch.Tensor                 # (B, 2, L, D) [uncond; cond]
    cond_embeds: torch.Tensor                # (B, 1, L, D) null-text caption embeds
    added_cfg: Optional[SdxlCond] = None     # SDXL: leaves (B, 2, ...)
    added_cond: Optional[SdxlCond] = None    # SDXL: leaves (B, 1, ...)
    added_uncond: Optional[SdxlCond] = None  # SDXL: leaves (B, 1, ...)


class BatchedEditOutputs(NamedTuple):
    edited: torch.Tensor         # (B, H, W, 3) in [0, 1]
    orig_score: torch.Tensor     # (B, num_outputs) VA of the input
    adapted_score: torch.Tensor  # (B, num_outputs) VA of the edit


def stack_conds(per_image: Sequence[BatchedConds]) -> BatchedConds:
    """Stack per-image BatchedConds (leaves without the batch axis) into one
    with the batch axis."""
    def stack(*leaves):
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], SdxlCond):
            return SdxlCond(*(stack(*parts) for parts in zip(*leaves)))
        return torch.stack(leaves)

    return BatchedConds(*(stack(*fields) for fields in zip(*per_image)))


def max_batch(pipe: InversionResamplingPipeline) -> int:
    """The largest batch whose CFG pair (2B latents) the flash-attention
    kernels take at every head count of the UNet: they launch one block per
    (batch, head) pair, at most ``MAX_BATCH_HEADS``."""
    return MAX_BATCH_HEADS // (2 * max(pipe.unet.cfg.attention_head_dim))


def check_batch(pipe: InversionResamplingPipeline, batch: int) -> None:
    """Raise, before any work, for a batch the kernels cannot take."""
    if batch > max_batch(pipe):
        raise ValueError(
            f"a batch of {batch} images is too large: the CFG pair runs {2 * batch} latents "
            f"through UNet attention of up to {max(pipe.unet.cfg.attention_head_dim)} heads, and "
            f"the flash-attention kernels take at most {MAX_BATCH_HEADS} (batch, head) pairs "
            f"(largest batch {max_batch(pipe)})")


def _rows(cond: Optional[SdxlCond], index: int) -> Optional[SdxlCond]:
    """Row ``index`` of each image's (B, n, ...) conds, as (B, ...)."""
    if cond is None:
        return None
    return SdxlCond(cond.text_embeds[:, index], cond.time_ids[:, index])


def _pair(cond: Optional[SdxlCond]) -> Optional[SdxlCond]:
    """(B, 2, ...) [uncond; cond] per image -> (2B, ...): B uncond rows, then
    B cond rows, the CFG pair's layout."""
    if cond is None:
        return None
    return SdxlCond(*(torch.cat([x[:, 0], x[:, 1]]) for x in cond))


def _windows(n: int, chunk_steps: Optional[int]) -> List[Tuple[int, int]]:
    if not chunk_steps:
        return [(0, n)]
    return [(a, min(a + chunk_steps, n)) for a in range(0, n, chunk_steps)]


def edit_program(pipe: InversionResamplingPipeline, *, chunk_steps: Optional[int] = None,
                 guidance_scale: float = 2.0, guidance_clf_scale: float = 0.2,
                 use_nto: bool = True, use_reference: bool = False,
                 end_iteration: Optional[int] = None, num_inner_steps: int = 10,
                 nto_epsilon: float = 1e-5, guidance_rescale: float = 0.0,
                 midu_is_minimized: bool = True):
    """The batched edit driven through the pipeline's window methods
    (``invert_steps``, ``null_optimization_steps``, ``sample_steps``), in
    windows of ``chunk_steps`` diffusion steps (None: one window per phase).
    ``make_batched_edit`` and ``make_segmented_edit`` are this program."""
    s = pipe.sched.num_inference_steps
    end_it = end_iteration if end_iteration is not None else s
    start_iteration = s - end_it

    @torch.no_grad()
    def program(images: torch.Tensor, empty_embeds: torch.Tensor, conds: BatchedConds,
                alpha: torch.Tensor, added_empty: Optional[SdxlCond] = None,
                log: Optional[RunLog] = None) -> BatchedEditOutputs:
        b = images.shape[0]
        check_batch(pipe, b)
        log = log if log is not None else RunLog()
        empty = empty_embeds.expand(b, -1, -1)
        added_e = None
        if added_empty is not None:
            added_e = SdxlCond(*(x.expand(b, -1) for x in added_empty))

        clock = PhaseClock(pipe.device, log)
        with clock.phase("score"):
            orig = pipe.score(images, empty_embeds, added_empty)
            reference_value = torch.clamp(orig + alpha, 0.0, 1.0) if use_reference else None
        with clock.phase("encode"):
            latents = pipe.encode_image(images)

        # Inversion; pivots[0] is the clean latent, as in reverse_sample.
        with clock.phase("invert"):
            ts, src_ts, i_vals = pipe.invert_tables(end_it)
            lat = latents
            state = SCH.dpm_init_state(lat.shape, lat.dtype, lat.device)
            parts = [latents[None]]
            for a, z in _windows(len(ts), chunk_steps):
                lat, state, pivots = pipe.invert_steps(lat, state, empty, added_e, ts[a:z],
                                                       src_ts[a:z], i_vals[a:z])
                parts.append(pivots)
            pivots = torch.cat(parts)                 # (K+1, B, h, w, c)
            noisy = lat
        log.tensors.update(latents=latents, noisy=noisy)

        nto_embeds = None
        if use_nto:
            with clock.phase("nto"):
                idx = torch.clamp(s - 1 - torch.arange(s), 0, pivots.shape[0] - 1)
                pivots_rev = pivots[idx.to(pivots.device)]
                lat_cur, uncond = pivots[-1], empty
                parts = []
                for a, z in _windows(s, chunk_steps):
                    lat_cur, uncond, part = pipe.null_optimization_steps(
                        lat_cur, uncond, pivots_rev[a:z], conds.cond_embeds[:, 0],
                        torch.arange(a, z), guidance_scale,
                        added_cond=_rows(conds.added_cond, 0),
                        added_uncond=_rows(conds.added_uncond, 0),
                        num_inner_steps=num_inner_steps, epsilon=nto_epsilon, log=log)
                    parts.append(part)
                nto_embeds = torch.cat(parts)         # (S, B, L, D)
            log.tensors["nto_embeds"] = nto_embeds

        with clock.phase("sample"):
            if guidance_scale > 1.0:
                prompt = torch.cat([conds.cfg_embeds[:, 0], conds.cfg_embeds[:, 1]])
            else:
                prompt = conds.cfg_embeds[:, 1]
            added_cfg = _pair(conds.added_cfg)
            ts, next_ts, i_vals = pipe.sample_tables(start_iteration)
            lat = noisy
            state = SCH.dpm_init_state(lat.shape, lat.dtype, lat.device)
            for a, z in _windows(len(ts), chunk_steps):
                lat, state = pipe.sample_steps(
                    lat, state, prompt, added_cfg, ts[a:z], next_ts[a:z], i_vals[a:z],
                    guidance_scale=guidance_scale, guidance_clf_scale=guidance_clf_scale,
                    guidance_rescale=guidance_rescale, uncond_embeds_per_step=nto_embeds,
                    midu_is_minimized=midu_is_minimized, midu_reference_value=reference_value,
                    log=log)
        log.tensors["out_latents"] = lat
        with clock.phase("decode"):
            edited = pipe.decode_latents(lat)
        with clock.phase("rescore"):
            adapted = pipe.score(edited, empty_embeds, added_empty)
        return BatchedEditOutputs(edited=edited, orig_score=orig, adapted_score=adapted)

    return program


def make_batched_edit(pipe: InversionResamplingPipeline, **kwargs):
    """Build ``program(images, empty_embeds, conds, alpha, added_empty=None,
    log=None) -> BatchedEditOutputs``; ``kwargs`` are ``edit_program``'s
    options (guidance_scale=2.0, guidance_clf_scale=0.2, use_nto=True,
    use_reference=False, end_iteration=None, num_inner_steps=10,
    nto_epsilon=1e-5, guidance_rescale=0.0, midu_is_minimized=True), the
    JAX function's.

    ``images`` (B, H, W, 3) in [0, 1] (already transform_image'd) on the
    pipeline's device; ``empty_embeds`` (1, L, D) the empty-prompt embeddings
    shared by inversion and scoring (the adapter's semantics: revert_and_sample
    inverts with empty prompts, reference pipeline.py:83-84); ``alpha`` (B,
    num_outputs) relative VA offsets, used only when ``use_reference`` (the
    reference value computed per image WITHOUT the reference's shared-config
    mutation, src/adapt_images/adapter.py:33-36); ``added_empty`` SDXL's
    empty-prompt added conds, one row. ``log`` (a ``RunLog``) receives the
    null-text steps, the guidance gradient norms and the seconds per phase.
    """
    return edit_program(pipe, chunk_steps=None, **kwargs)
