"""The processes' layout and the data axis's collectives (port of
``rgie_tpu/parallel/mesh.py`` and of ``create_hybrid_mesh`` in
``rgie_tpu/parallel/distributed.py``).

Per-image edits are embarrassingly parallel, so the port's one axis is
``data``: each process runs one device and edits its own rows. JAX's
``model`` axis shards weight output channels over devices (``shard_model``,
``model_sharding``); its port, on DTensor, is the last open item of ROADMAP
queue 1, so a model axis above 1 raises here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rgie_tpu_torch.parallel.distributed import process_info

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MODEL_AXIS_LATER = ("a model axis above 1 (tensor parallelism over weight output channels: JAX's "
                     "shard_model / model_sharding) is not ported yet: it is the last open item of "
                     "ROADMAP queue 1")


class Mesh(NamedTuple):
    """(data, model) sizes over the processes, one device each."""

    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def create_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """(data, model) mesh over the processes. Default: all on the data axis,
    the layout of batched per-image editing."""
    nproc = process_info()[1]
    if shape is None:
        shape = (nproc, 1)
    if shape[0] * shape[1] != nproc:
        raise ValueError(f"mesh shape {shape} != {nproc} processes")
    if shape[1] > 1:
        raise NotImplementedError(_MODEL_AXIS_LATER)
    return Mesh(*shape)


def create_hybrid_mesh(model_parallel: int = 1) -> Mesh:
    """The multi-host mesh: the data axis takes every process. JAX keeps a
    model axis inside one slice; here it is 1 (see the module's docstring)."""
    nproc = process_info()[1]
    if nproc % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} !| {nproc} processes")
    return create_mesh((nproc // model_parallel, model_parallel))


def pad_to_multiple(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple by repeating the last row. Returns
    (padded, original_length)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem:
        pad = np.repeat(batch[-1:], rem, axis=0)
        batch = np.concatenate([batch, pad], axis=0)
    return batch, n


def all_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced, in place, by its mean over the processes, and returned
    (JAX: ``pmean`` over the data axis). A sum all-reduce divided by the
    world size: gloo has no average reduction, and every rank divides the
    same sum, so the ranks end bit-identical. One process: ``x`` as it is."""
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        x.div_(dist.get_world_size())
    return x
