"""Segmented batched diffusion edit. Port of
``rgie_tpu/diffusion/segmented.py``.

``make_segmented_edit`` is the batched edit (``diffusion/batched.py``) run in
windows of at most ``chunk_steps`` diffusion steps: inversion windows,
null-text optimization windows and sampling windows, chained from the host
through the pipeline's window methods (``invert_steps``,
``null_optimization_steps``, ``sample_steps``), with the latents, the DPM
state and the null-text embeddings carried across. The JAX package needs it
to split one long XLA execution; the port's loops already run step by step
from the host, so it keeps this form only so that ``--segment K`` means
the same thing in both packages. The windows change nothing the edit
computes: on the CPU a segmented edit equals the whole one bit for bit.

Reference parity: the edit semantics are those of ``revert_and_sample``
(``src/pipelines/InversionResamplingDiffusionPipeline.py:74-122``).
"""

from __future__ import annotations

from rgie_tpu_torch.diffusion.batched import edit_program
from rgie_tpu_torch.diffusion.pipeline import InversionResamplingPipeline


def make_segmented_edit(pipe: InversionResamplingPipeline, *, chunk_steps: int = 8, **kwargs):
    """Build ``program(images, empty_embeds, conds, alpha, added_empty=None,
    log=None) -> BatchedEditOutputs`` with the contract and the options of
    ``make_batched_edit``, run in windows of at most ``chunk_steps`` steps."""
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be at least 1, got {chunk_steps}")
    return edit_program(pipe, chunk_steps=chunk_steps, **kwargs)
