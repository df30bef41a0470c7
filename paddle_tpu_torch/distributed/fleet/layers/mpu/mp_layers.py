"""Model-parallel layers: the counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``
(``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy``).

Each layer holds its full logical weight (the parameter a checkpoint and an
optimizer see, marked with its Megatron placement over the hybrid mesh's
mp axis) and computes rank by rank over the mp group, every rank's slice
of the weight on its own device: the column-parallel product per column
block (then an all-gather when ``gather_output``), the row-parallel one
per row block then one all-reduce, the embedding per vocab range then one
all-reduce, the cross-entropy per vocab range (``mp_ops``). Gradients flow
to the full weights through the autograd functions of ``mp_ops``. Without
a topology of more than one mp rank (``fleet.init``), each layer is the
plain one.

Constructors take the JAX layers' arguments, then keyword-only
``device=`` (default: the card) and ``dtype=``; weights start
Xavier-normal, biases zero, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from .....device import resolve_device
from .....nn import functional as F
from .mp_ops import (Gather, ReduceSum, Scatter, Split, _chunks, annotate,
                     mp_group, vocab_parallel_cross_entropy)


def _weight(shape, device, dtype):
    w = torch.empty(shape, device=resolve_device(device), dtype=dtype)
    nn.init.xavier_normal_(w)
    return nn.Parameter(w)


def _divisible(n, g, what):
    if g is not None and n % g.nranks:
        raise ValueError(f"{what} {n} does not split over {g.nranks} mp "
                         "ranks")


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _weight((num_embeddings, embedding_dim), device, dtype)
        annotate(self.weight, 0)        # the vocab dim over mp
        _divisible(num_embeddings, _mp(), "vocab")

    def forward(self, x):
        g = _mp()
        if g is None:
            return self.weight[x.long()]
        ids = x.long()
        parts = []
        for (lo, hi), d in zip(_chunks(self.num_embeddings, g.nranks),
                               g.devices):
            local = ids.to(d)
            mine = (local >= lo) & (local < hi)
            rows = self.weight[lo:hi].to(d)[
                torch.where(mine, local - lo, torch.zeros_like(local))]
            parts.append(rows * mine[..., None].to(rows.dtype))
        return ReduceSum.apply(*parts)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = _weight((in_features, out_features), device, dtype)
        annotate(self.weight, 1)        # columns over mp
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, device=self.weight.device, dtype=dtype))
            annotate(self.bias, 0)
        else:
            self.bias = None
        _divisible(out_features, _mp(), "out_features")

    def forward(self, x):
        g = _mp()
        if g is None:
            return F.linear(x, self.weight, self.bias)
        xs = Scatter.apply(x, g.devices)
        outs = []
        for (a, b), xr, d in zip(_chunks(self.out_features, g.nranks), xs,
                                 g.devices):
            bias = None if self.bias is None else self.bias[a:b].to(d)
            outs.append(F.linear(xr, self.weight[:, a:b].to(d), bias))
        if self.gather_output:
            return Gather.apply(-1, *outs)
        # the global view of a column-sharded output (no communication:
        # each rank keeps its piece; the single controller reads them all)
        home = self.weight.device
        return annotate(torch.cat([o.to(home) for o in outs], dim=-1), -1)


class RowParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _weight((in_features, out_features), device, dtype)
        annotate(self.weight, 0)        # rows over mp
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(
                out_features, device=self.weight.device, dtype=dtype))
        else:
            self.bias = None
        _divisible(in_features, _mp(), "in_features")

    def forward(self, x):
        g = _mp()
        if g is None:
            return F.linear(x, self.weight, self.bias)
        xs = Split.apply(x, -1, g.devices)
        parts = [F.linear(xr, self.weight[a:b].to(d))
                 for (a, b), xr, d in zip(_chunks(self.in_features,
                                                  g.nranks), xs, g.devices)]
        out = ReduceSum.apply(*parts)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy over vocab-sharded logits, rank by rank
    (``mp_layers.py`` ParallelCrossEntropy): the loss [...] per label, 0
    where the label is ignore_index."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        g = _mp()
        devices = g.devices if g is not None else [input.device]
        lbl = label[..., 0] if label.dim() == input.dim() else label
        return vocab_parallel_cross_entropy(input, lbl, devices,
                                            self.ignore_index)


def _mp():
    return mp_group()
