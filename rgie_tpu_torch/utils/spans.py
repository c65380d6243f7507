"""Named ranges of the port's work on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is recording, so that a trace names the program's phases, loop steps
and attention calls beside the device work they launch (the chrome trace of
``cli/profile_adapt_images.py``, or a trace recording user-scope ranges only).
While no profiler runs it returns one shared no-op context and builds no name:
a range costs a call and a flag test, where ``record_function`` itself costs
microseconds even with no profiler.

The ranges, innermost last:

* ``edit.<phase>`` (``PhaseClock``): score, encode, invert, nto, sample,
  decode, rescore (the single-image adapter adds prompts and
  save_and_rescore); each ends after the device has finished its work;
* ``nto.outer`` > ``nto.cond``, ``nto.inner`` > (``nto.loss_grad``,
  ``nto.adam``, ``nto.readback``), ``nto.cfg_step``;
* ``sample.step`` > ``sample.cfg``, ``sample.sched``, ``sample.guidance``;
* ``attn.<route>.<type>.<B>x<H>x<N>x<M>x<d>`` around the attention of one
  module call, from q, k and v to the output before ``to_out`` (forward
  only): route ``k2`` (the flash-attention kernels) or ``matmul``;
* ``train.step``, and ``train.features`` > ``train.teacher``,
  ``train.encode``, ``train.unet``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()

#: The short names of the types in an attention range's name.
TYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
              torch.float64: "f64"}


def span(name: str, *args):
    """A profiler range named ``name % args`` (``name`` itself without
    ``args``) around the block, or the shared no-op context while no profiler
    records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name % args if args else name)


def attention_span(route: str, dtype: torch.dtype, batch: int, heads: int, n: int, m: int,
                   width: int):
    """``span`` of one attention call of ``heads`` heads of ``width`` over
    ``n`` queries and ``m`` keys, in ``dtype``, by ``route``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(
        f"attn.{route}.{TYPE_NAMES[dtype]}.{batch}x{heads}x{n}x{m}x{width}")
