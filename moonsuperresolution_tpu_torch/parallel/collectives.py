"""The collectives of data- and tensor-parallel runs, over one axis of the
mesh (``Axis``: its process group, this process's index on it, its size).

Every collective is an all-reduce (sum), so the same code runs under NCCL
and under gloo, CUDA tensors included.  bf16 and fp16 tensors are summed in
float32 and cast back.  An axis without a group (one process) makes each of
them the identity, and an axis with a group of one process still runs the
collective (what a world of one measures).

Autograd rules, where ``L_r`` is process ``r``'s loss and the run's
objective is their mean over the data axis, ``L = mean_r L_r``:

- ``all_reduce_sum``: forward and backward both sum.  The SPADE and
  BatchNorm moments of the global batch are sums over every process's
  rows; each process's backward then holds the gradient of ``sum_r L_r``
  along its own rows, and the trainers' mean of the gradients over the
  data axis is ``dL``.
- ``reduce_from_model``: forward sums the partial products of a
  row-parallel layer; backward is the identity (every process of the model
  group computes the same loss from the same sum).
- ``copy_to_model``: forward is the identity; backward sums the gradients
  of a replicated tensor that each process of the model group used only in
  part (its column slice), so that replicated parameters get their whole
  gradient on every process.
- ``gather_from_model``: forward assembles the shards of a column-parallel
  output along ``dim`` (an all-reduce of a zero-padded buffer); backward
  takes this process's slice of the (identical) gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this process sees it."""

    group: Optional[object] = None   # a ProcessGroup; None: one process
    index: int = 0
    size: int = 1

    def part(self, n: int) -> slice:
        """This process's slice of ``n`` items split evenly over the axis."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} processes")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


ONE = Axis()     # a single process: no group, every collective the identity


def _sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A new tensor: ``t`` summed over the axis (float32 for half types)."""
    wide = t.dtype in (torch.bfloat16, torch.float16)
    buf = t.float() if wide else t.clone()
    if axis.group is not None:
        dist.all_reduce(buf, group=axis.group)
    return buf.to(t.dtype) if wide else buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return gather_whole(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return g.narrow(ctx.dim, a.index * ctx.n, ctx.n), None, None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _AllReduceSum.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _ReduceFromModel.apply(x, axis)


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.group is None else _CopyToModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return x if axis.group is None else _GatherFromModel.apply(x, axis, dim)


def gather_whole(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The whole tensor from each process's equal shard along ``dim`` (no
    autograd): every process gets the same result."""
    if axis.group is None:
        return t
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * axis.size
    buf = t.new_zeros(shape)
    buf.narrow(dim, axis.index * n, n).copy_(t.detach())
    return _sum(buf, axis)


def average_(tensors: list[torch.Tensor], axis: Axis) -> None:
    """Replaces each tensor by its mean over the axis, in place, with one
    all-reduce of a flat float32 buffer."""
    if axis.group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    flat /= axis.size
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset : offset + n].view_as(t))
        offset += n
