"""Tensor parallelism over weight output channels: ``shard_model`` (port of
``shard_model`` in ``rgie_tpu/parallel/mesh.py``).

JAX places each weight with ``model_sharding`` and lets GSPMD insert the
collectives. Here ``shard_model`` walks a module in place and, on each rank
of a model group, keeps only the rank's slice of every parameter the rule
shards; the collectives are explicit:

* ``Conv2d`` and ``Linear`` are column-parallel: they compute only their
  own output channels from the local weight slice, then gather the channels
  back to the full activation. The gather's backward keeps the rank's own
  slice of the gradient, with no collective; at the layer's input a "copy",
  the identity forward, all-reduces (sums) the input gradient in its
  backward, since a column slice yields only part of it (Megatron's pattern).
* Any other module's sharded parameters (GroupNorm and LayerNorm scales and
  biases, an Embedding table) are gathered whole for its forward.

Everything between the layers, attention included, runs on full-width
activations on every rank of the group, so the model's callers see the
shapes they see in one process. A gather is ``all_gather`` of the slices,
joined in rank order: the same bits on every rank.

Every rank of a group runs the same layers in the same order, so their
collectives pair up. ``state_dict()`` of a sharded module gathers the full
tensors (a collective too: every rank of the group calls it), so a
checkpoint written under tensor parallelism equals one process's;
``load_state_dict`` takes full tensors and keeps each rank's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import Shard

from rgie_tpu_torch.parallel.mesh import Mesh, model_sharding


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A rank's model group: the group, the rank's place in it, its size."""

    group: object
    index: int
    size: int

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, in place, the largest over the group: a decision taken from
        it is the same on every rank."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def mean_(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, in place, its mean over the group: equal on every rank."""
        dist.all_reduce(x, group=self.group)
        return x.div_(self.size)


def _gather(local: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(axis.size)]
    dist.all_gather(parts, local, group=axis.group)
    return torch.cat(parts, dim=dim)


class _GatherChannels(torch.autograd.Function):
    """Forward: the model group's slices along ``dim`` joined in rank order.
    Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, local, dim, axis):
        ctx.dim, ctx.start, ctx.n = dim, axis.index * local.shape[dim], local.shape[dim]
        return _gather(local, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the group's gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


def gather(local: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The full tensor from each rank's slice along ``dim`` (differentiable)."""
    return _GatherChannels.apply(local, dim % local.ndim, axis)


class _ColumnParallel:
    """Mixin of a sharded ``Conv2d`` or ``Linear``: the layer's own forward on
    the local weight slice, then the channels gathered."""

    def forward(self, x, *args, **kwargs):
        axis = self._model_axis
        if torch.is_grad_enabled() and x.requires_grad:
            x = _CopyToModel.apply(x, axis)
        y = super().forward(x, *args, **kwargs)
        return gather(y, 1 if isinstance(self, nn.Conv2d) else -1, axis)


class _GatheredParameters:
    """Mixin of any other module with sharded parameters: they are gathered
    whole for the module's forward, then the slices put back."""

    def forward(self, *args, **kwargs):
        params = self._parameters
        local = {name: params[name] for name in self._model_shards}
        try:
            for name, (dim, _) in self._model_shards.items():
                params[name] = gather(local[name], dim, self._model_axis)
            return super().forward(*args, **kwargs)
        finally:
            params.update(local)


_CLASSES: Dict[tuple, type] = {}


def _sharded_class(mixin: type, cls: type) -> type:
    if (mixin, cls) not in _CLASSES:
        _CLASSES[mixin, cls] = type(f"ModelParallel{cls.__name__}", (mixin, cls), {})
    return _CLASSES[mixin, cls]


def _gather_state(module, state_dict, prefix, local_metadata):
    with torch.no_grad():
        for name, (dim, _) in module._model_shards.items():
            if prefix + name in state_dict:
                state_dict[prefix + name] = _gather(state_dict[prefix + name], dim,
                                                    module._model_axis)


def _slice_state(module, state_dict, prefix, *_):
    axis = module._model_axis
    for name, (dim, full) in module._model_shards.items():
        value = state_dict.get(prefix + name)
        if value is not None and value.ndim > dim and value.shape[dim] == full:
            n = full // axis.size
            state_dict[prefix + name] = value.narrow(dim, axis.index * n, n)


def model_axis_of(module: nn.Module) -> Optional[ModelAxis]:
    """The model group ``module`` was sharded over, or None."""
    return getattr(module, "_model_axis", None)


def model_shards(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """``{parameter name: (dim, full size)}`` of every sharded parameter of
    ``module`` and its children."""
    out = {}
    for prefix, sub in module.named_modules():
        for name, spec in getattr(sub, "_model_shards", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = spec
    return out


def shard_model(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard ``module`` in place over ``mesh``'s model axis and return it:
    every parameter that ``model_sharding`` shards keeps only this rank's
    slice (see the module's docstring for the forward). A model axis of 1
    leaves the module as it is. The module's forward and ``state_dict`` are
    then collectives over the model group."""
    if mesh.model == 1:
        return module
    j = mesh.coords()[1]
    axis = ModelAxis(mesh.model_group(), j, mesh.model)
    for sub in list(module.modules()):
        shards = {}
        for name, p in sub.named_parameters(recurse=False):
            placement = model_sharding(p, mesh, sub)[1]
            if isinstance(placement, Shard):
                shards[name] = (placement.dim, p.shape[placement.dim])
        if not shards:
            continue
        weights = sorted(n for n in shards if sub._parameters[n].ndim > 1)
        if isinstance(sub, (nn.Conv2d, nn.Linear)):
            mixin = _ColumnParallel
        elif weights and not isinstance(sub, nn.Embedding):
            # e.g. a transposed convolution, whose output channels are dim 1
            raise NotImplementedError(f"{type(sub).__name__}: no column-parallel forward for "
                                      f"its weights {weights}")
        else:
            mixin = _GatheredParameters
        for name, (dim, full) in shards.items():
            p = sub._parameters[name]
            n = full // axis.size
            sub._parameters[name] = nn.Parameter(p.detach().narrow(dim, j * n, n).clone(),
                                                 requires_grad=p.requires_grad)
        sub._model_shards, sub._model_axis = shards, axis
        sub.__class__ = _sharded_class(mixin, type(sub))
        sub.register_state_dict_post_hook(_gather_state)
        sub.register_load_state_dict_pre_hook(_slice_state)
    module._model_axis = axis
    return module
