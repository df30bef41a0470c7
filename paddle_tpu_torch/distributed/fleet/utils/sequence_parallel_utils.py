"""Sequence-parallel utilities: the counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``
(``ScatterOp``, ``GatherOp``, ``AllGatherOp``, ``ReduceScatterOp``,
``scatter``, ``all_gather``, ``ColumnSequenceParallelLinear`` :82,
``RowSequenceParallelLinear`` :103, the sequence-parallel parameter
marks).

Megatron sequence parallelism: between the tensor-parallel linears the
activations are split along the sequence over the mp axis. As in the JAX
package each op keeps the GLOBAL values and re-lays them out (the
placements over the hybrid mesh's mp axis, ``mp_ops.annotate``;
``local_shards`` gives each rank's piece), keeping the autograd graph.
The two linears compute rank by rank over the mp group, as the port's
mpu layers do: the column one gathers the sequence (the input's global
values), multiplies each rank's column block on its device and returns
the column-split output; the row one multiplies each rank's row block by
its piece of the input and reduce-scatters the partial sums along the
sequence (counted ``reduce_scatter``; its backward all-gathers the
gradient, counted ``all_gather``). Without an mp group of more than one
rank every op is the identity and the linears are plain.
"""

from __future__ import annotations

import torch
from torch import nn

from ....device import resolve_device
from ....nn import functional as F
from ... import parallel_base as pb
from ..layers.mpu.mp_ops import Scatter, Split, _chunks, annotate, mp_group


def _relaid(x, dim):
    if mp_group() is None:
        return x
    return annotate(x.view_as(x), dim)


class ScatterOp:
    """Split activations along the sequence dim (dim 1 of [B, S, H])
    over the mp ranks."""

    @staticmethod
    def apply(x, axis=1):
        return _relaid(x, axis)


class GatherOp:
    @staticmethod
    def apply(x, axis=1):
        return _relaid(x, None)


class AllGatherOp:
    @staticmethod
    def apply(x):
        return _relaid(x, None)


class ReduceScatterOp:
    @staticmethod
    def apply(x):
        return _relaid(x, 1 if x.dim() > 1 else 0)


def scatter(x, axis=1):
    return ScatterOp.apply(x, axis)


def all_gather(x):
    return AllGatherOp.apply(x)


class _ReduceScatterSeq(torch.autograd.Function):
    """Per-rank partial sums [B, S, H] -> the sum, rank r keeping
    sequence slice r: the global values, the slices concatenated on rank
    0's device. The backward hands every rank the whole gradient (an
    all-gather of the slices)."""

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.devices = [p.device for p in parts]
        n = len(parts)
        pb._count_collective("reduce_scatter", list(parts))
        home = parts[0].device
        pieces = []
        for r, (a, b) in enumerate(_chunks(parts[0].shape[dim], n)):
            acc = parts[0].narrow(dim, a, b - a).to(home)
            for q in parts[1:]:
                acc = acc + q.narrow(dim, a, b - a).to(home)
            pieces.append(acc)
        return torch.cat(pieces, dim=dim)

    @staticmethod
    def backward(ctx, g):
        pb._count_collective("all_gather", g)
        return (None,) + tuple(g.to(d) for d in ctx.devices)


def _weight(shape, device, dtype):
    w = torch.empty(shape, device=resolve_device(device), dtype=dtype)
    nn.init.xavier_normal_(w)
    return nn.Parameter(w)


class ColumnSequenceParallelLinear(nn.Module):
    """The input arrives split along the sequence; it is gathered (its
    global values), each rank computes its column block, and the output
    leaves split by columns over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _weight((in_features, out_features), device, dtype)
        annotate(self.weight, 1)
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=self.weight.device, dtype=dtype)) \
            if has_bias else None
        if self.bias is not None:
            annotate(self.bias, 0)

    def forward(self, x):
        x = AllGatherOp.apply(x)
        g = mp_group()
        if g is None:
            return F.linear(x, self.weight, self.bias)
        xs = Scatter.apply(x, g.devices)
        outs = []
        for (a, b), xr, d in zip(_chunks(self.out_features, g.nranks), xs,
                                 g.devices):
            bias = None if self.bias is None else self.bias[a:b].to(d)
            outs.append(F.linear(xr, self.weight[:, a:b].to(d), bias))
        home = self.weight.device
        return annotate(torch.cat([o.to(home) for o in outs], dim=-1), -1)


class RowSequenceParallelLinear(nn.Module):
    """The input arrives split by columns over mp; each rank multiplies
    its row block, and the partial sums are reduce-scattered along the
    sequence (dim 1)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _weight((in_features, out_features), device, dtype)
        annotate(self.weight, 0)
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=self.weight.device, dtype=dtype)) \
            if has_bias else None

    def forward(self, x):
        g = mp_group()
        if g is None:
            return F.linear(x, self.weight, self.bias)
        xs = Split.apply(x, -1, g.devices)
        parts = [F.linear(xr, self.weight[a:b].to(d))
                 for (a, b), xr, d in zip(_chunks(self.in_features,
                                                  g.nranks), xs, g.devices)]
        dim = 1 if x.dim() > 2 else 0
        out = _ReduceScatterSeq.apply(dim, *parts)
        if self.bias is not None:
            out = out + self.bias
        return annotate(out, dim)


SPInnerOverlapLinear = ColumnSequenceParallelLinear


def mark_as_sequence_parallel_parameter(param):
    param._sequence_parallel = True


def is_sequence_parallel_parameter(param):
    return getattr(param, "_sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(model, *args, **kwargs):
    """The reference all-reduces the gradients of the marked parameters
    (layer norms run on sequence pieces) over mp. A port gradient is the
    global one already (the values are global, as under GSPMD in the JAX
    package, whose hook is likewise a no-op). Returns the marked
    parameters."""
    return [p for p in model.parameters()
            if is_sequence_parallel_parameter(p)]
