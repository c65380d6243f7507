"""The processes' (data, model) layout, the rule that shards a weight over the
model axis, and the collectives of the two axes (port of
``rgie_tpu/parallel/mesh.py`` and of ``create_hybrid_mesh`` in
``rgie_tpu/parallel/distributed.py``).

One process drives one device. The processes form a grid of ``data`` rows
and ``model`` columns, laid out as JAX's ``reshape(data, model)`` of its
device list: ranks ``d·m … d·m+m-1`` form model group ``d``, and the ranks
with the same column form a data group.

* ``data``: per-image edits are embarrassingly parallel, so each model group
  edits its own rows, and training averages gradients over the data groups.
* ``model``: tensor parallelism over weight output channels. Each rank of a
  model group keeps the ``model_sharding`` slice of every weight that the
  rule shards, computes only its own output channels and gathers the
  activation back to full width (``parallel/model_axis.py``'s
  ``shard_model``). The model axis never crosses a host: ``model`` must
  divide the processes of one host.

Under a process group, a mesh with a model axis above 1 makes its groups
when it is created, so every rank calls ``create_mesh`` (or
``create_hybrid_mesh``), in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import Replicate, Shard

from rgie_tpu_torch.parallel.distributed import process_info

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_grid(world: int, local_world: int, model: int) -> np.ndarray:
    """The ranks of a (world // model, model) mesh, row-major as JAX's
    ``np.asarray(devices).reshape(data, model)``. Raises when ``model`` does
    not divide the world, or the processes of one host (``local_world``): a
    model group must not cross a host."""
    if model < 1 or world % model:
        raise ValueError(f"model_parallel {model} !| {world} processes")
    if local_world % model:
        raise ValueError(
            f"model_parallel {model} must divide LOCAL_WORLD_SIZE {local_world}, the processes "
            "of one host (the model axis cannot cross hosts)")
    return np.arange(world).reshape(world // model, model)


def local_world_size() -> int:
    """The processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else all
    of them (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_info()[1]))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """(data, model) sizes over the processes, one device each, and, when the
    model axis is above 1, this rank's (model group, data group) as
    ``create_mesh`` made them."""

    data: int
    model: int = 1
    groups: Optional[tuple] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self) -> Tuple[int, int]:
        """This rank's (data, model) place in the grid."""
        rank = process_info()[0]
        return rank // self.model, rank % self.model

    def model_group(self):
        """This rank's model group, or None when the model axis is 1."""
        return self._groups()[0] if self.model > 1 else None

    def data_group(self):
        """The ranks holding the same weight shards as this one (None, the
        world, when the model axis is 1)."""
        return self._groups()[1] if self.model > 1 else None

    def _groups(self) -> tuple:
        if self.groups is None:
            raise RuntimeError(f"a mesh of model axis {self.model} has no process groups: make "
                               "it with create_mesh after init_distributed")
        return self.groups


def create_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """(data, model) mesh over the processes. Default: all on the data axis,
    the layout of batched per-image editing. Under a process group a model
    axis above 1 makes the mesh's groups here."""
    nproc = process_info()[1]
    if shape is None:
        shape = (nproc, 1)
    if shape[0] * shape[1] != nproc:
        raise ValueError(f"mesh shape {shape} != {nproc} processes")
    grid = rank_grid(nproc, local_world_size(), shape[1])
    if shape[1] == 1 or not dist.is_initialized():
        return Mesh(*shape)
    # Every rank makes every group, in the same order (``new_group``'s rule).
    model_groups = [dist.new_group(row.tolist()) for row in grid]
    data_groups = [dist.new_group(col.tolist()) for col in grid.T]
    rank = dist.get_rank()
    return Mesh(*shape, groups=(model_groups[rank // shape[1]], data_groups[rank % shape[1]]))


def create_hybrid_mesh(model_parallel: int = 1) -> Mesh:
    """The multi-host mesh: ``model_parallel`` processes of one host on the
    model axis, every other process on the data axis."""
    nproc = process_info()[1]
    if nproc % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} !| {nproc} processes")
    return create_mesh((nproc // model_parallel, model_parallel))


def model_sharding(param: torch.Tensor, mesh: Mesh, module: Optional[nn.Module] = None
                   ) -> tuple:
    """JAX's rule for one weight of ``module``: its output features are
    sharded over ``model`` when they divide by the axis and number at least
    twice it; anything smaller or non-divisible is replicated. JAX keeps
    output features last; torch keeps them in dim 0 of a ``Conv2d`` weight
    (O, I, kh, kw), a ``Linear`` weight (O, I) and every 1-D parameter, and
    last in an ``Embedding`` table (V, D), as JAX does. Returns the DTensor
    placements over (data, model): ``(Replicate(), Shard(k))`` or
    ``(Replicate(), Replicate())``."""
    m = mesh.model
    if param.ndim >= 1:
        k = param.ndim - 1 if isinstance(module, nn.Embedding) else 0
        n = param.shape[k]
        if m > 1 and n % m == 0 and n >= 2 * m:
            return Replicate(), Shard(k)
    return Replicate(), Replicate()


def pad_to_multiple(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple by repeating the last row. Returns
    (padded, original_length)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem:
        pad = np.repeat(batch[-1:], rem, axis=0)
        batch = np.concatenate([batch, pad], axis=0)
    return batch, n


def all_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` replaced, in place, by its mean over ``group`` (default: every
    process), and returned (JAX: ``pmean``). A sum all-reduce divided by the
    group's size: gloo has no average reduction, and every rank divides the
    same sum, so the ranks end bit-identical. One process: ``x`` as it is."""
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.div_(dist.get_world_size(group))
    return x
