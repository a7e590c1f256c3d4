"""Column-parallel layers over the 'model' mesh axis (the port's form of
the tensor sharding the JAX package's step runs under `param_shardings`,
where GSPMD places the collectives).

A layer whose weight `param_shardings` splits keeps this rank's block of
its output features (`parallel.mesh.shard_parameters` puts the layer in
its module's place) and every activation between layers stays whole and
alike on the ranks of the model group. Per split layer:

    x, and every replicated tensor the local computation reads
        -> f: identity; the backward sums their gradients over the group
    local outputs = the layer on this rank's weight block
        -> g: all-gather along the feature axis (the blocks of a fused
           q/k/v weight back in [q | k | v] order); the backward keeps
           this rank's slice of the incoming gradient

(Megatron's f/g pair). A bias is replicated, as in the JAX rule, and is
read through f, sliced to this rank's features. Each rank so computes a
split layer's output features alone, and its weight block's gradient is
the gradient of that block of the whole layer. The collectives are counted
by `parallel.mesh` (`all_gather`, `all_reduce_sum`). Both Functions read
no device value on the host and allocate only through the caching
allocator (the gathered parts, the flat gradient buffer), so under NCCL
the Trainer's step program captures them whole: their collectives in the
graph, their buffers in its pool.

The resnet convs run as K2 on the local block (`models/unet.py::
ResnetBlock1D`, through `column_parallel`): K2 takes `co` = C_out / mp
with x, a and b whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ns2vc_tpu_torch.parallel.mesh import (
    Placement, all_gather, all_reduce_sum, shard_tensor,
)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnSplit:
    """A layer's split: the model group, this rank's index in it, its size,
    and the blocks the output features stack (3 for a fused q/k/v)."""
    group: object
    index: int
    size: int
    blocks: int = 1

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's features of a full tensor whose dim 0 holds the
        output features (a bias)."""
        return shard_tensor(t, Placement("model", 0, self.blocks), self.index,
                            self.size)


class _ToModelGroup(torch.autograd.Function):
    """f: the inputs as they are; the backward sums their gradients over
    the model group in one f32 all-reduce."""

    @staticmethod
    def forward(ctx, split, *xs):
        ctx.group = split.group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        idx = [i for i, n in enumerate(need) if n]
        out = [None] * len(grads)
        if idx:
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            all_reduce_sum(flat, ctx.group)
            parts = flat.split([grads[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view_as(grads[i]).to(grads[i].dtype)
        return (None, *out)


class _GatherFeatures(torch.autograd.Function):
    """g: every rank's output features gathered along the last axis, the
    blocks reordered to [block 0 of every rank | block 1 ...]; the
    backward keeps this rank's slice of each block."""

    @staticmethod
    def forward(ctx, split, y):
        ctx.split = split
        parts = [p.unflatten(-1, (split.blocks, -1))
                 for p in all_gather(y, split.group)]
        return torch.stack(parts, dim=-2).flatten(-3)

    @staticmethod
    def backward(ctx, dy):
        s = ctx.split
        d = dy.unflatten(-1, (s.blocks, s.size, -1))[..., s.index, :]
        return None, d.flatten(-2).contiguous()


def column_parallel(split: ColumnSplit | None, local_fn, *replicated):
    """`local_fn(*replicated)` computes this rank's output features of a
    split layer from the tensors it reads whole; returns the layer's
    whole output. `split` None (the layer is not split): `local_fn` is the
    layer."""
    if split is None:
        return local_fn(*replicated)
    if torch.is_grad_enabled() and any(t.requires_grad for t in replicated):
        replicated = _ToModelGroup.apply(split, *replicated)
    return _GatherFeatures.apply(split, local_fn(*replicated))


def _promoted(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None):
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


class ColumnParallelLinear(nn.Module):
    """A Linear layer split by output features: `weight` this rank's block
    (out / mp, in), `bias` the whole replicated (out,). Computes in the
    common type of input and parameters, as the encoders' `Linear`."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter | None,
                 split: ColumnSplit):
        super().__init__()
        self.weight, self.bias, self.split = weight, bias, split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def local(x, *bias):
            b = self.split.local(bias[0]) if bias else None
            return F.linear(*_promoted(x, self.weight, b))
        return column_parallel(self.split, local, x,
                               *(() if self.bias is None else (self.bias,)))


class ColumnParallelConv1d(nn.Module):
    """A Conv1d split by output channels on (B, T, C), as
    `models/layers.py::Conv1d`: `weight` this rank's block (Co / mp, C, K),
    `bias` the whole replicated (Co,). The resnet convs' blocks are read by
    K2's call instead (`ResnetBlock1D`)."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter | None,
                 split: ColumnSplit, stride, padding):
        super().__init__()
        self.weight, self.bias, self.split = weight, bias, split
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def local(x, *bias):
            b = self.split.local(bias[0]) if bias else None
            x, w, b = _promoted(x, self.weight, b)
            return F.conv1d(x.transpose(1, 2), w, b, self.stride,
                            self.padding).transpose(1, 2)
        return column_parallel(self.split, local, x,
                               *(() if self.bias is None else (self.bias,)))


def split_layer(model: nn.Module, owner: str, attr: str,
                placement: Placement, group, index: int, size: int) -> None:
    """Put the column-parallel form of the layer `owner` of `model` in its
    place, holding model rank `index`'s block of its parameter `attr`
    (split by `placement`). Raises for a parameter no layer here splits."""
    layer = model.get_submodule(owner)
    kind = (ColumnParallelLinear if isinstance(layer, nn.Linear) else
            ColumnParallelConv1d if isinstance(layer, nn.Conv1d)
            and layer.groups == 1 and layer.padding_mode == "zeros" else None)
    if kind is None or attr != "weight" or placement.dim != 0:
        raise NotImplementedError(
            f"no column-parallel layer splits {owner}.{attr} "
            f"({type(layer).__name__}, {placement})")
    w = layer.weight
    block = nn.Parameter(shard_tensor(w.detach(), placement, index, size),
                         requires_grad=w.requires_grad)
    split = ColumnSplit(group, index, size, placement.blocks)
    new = (ColumnParallelLinear(block, layer.bias, split)
           if kind is ColumnParallelLinear else
           ColumnParallelConv1d(block, layer.bias, split, layer.stride,
                                layer.padding))
    parent, _, child = owner.rpartition(".")
    setattr(model.get_submodule(parent), child, new)
