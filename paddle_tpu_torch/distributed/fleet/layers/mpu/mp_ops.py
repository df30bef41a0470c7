"""Model-parallel operations: the counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py`` (``_c_identity``,
``_c_split``, ``_c_concat``, ``_mp_allreduce``, ``_c_lookup_table``,
``_c_softmax_with_cross_entropy``, ``split``).

As in the JAX package, the public operations take and return tensors of
GLOBAL values: ``_c_split`` lays its input out by its last dim over the mp
axis, ``_c_concat`` and ``_mp_allreduce`` lay it out replicated, each
keeping the values and the autograd graph (the JAX package reshards, and
GSPMD inserts the collectives). ``_c_softmax_with_cross_entropy`` is the
vocab-parallel softmax cross-entropy, computed shard by shard.

The mpu layers compute the Megatron way, rank by rank of the mp group
(every rank driven by this one process, on its own device): the autograd
functions below move values between the replicated and the per-rank
layouts, and their backward passes are the collectives the reference's
``_c_identity`` / ``_mp_allreduce`` / ``_c_split`` / ``_c_concat`` run
(an all-reduce of the input gradients, the identity, an all-gather, a
split).
"""

from __future__ import annotations

import numpy as np
import torch

from ....auto_parallel.api import DistAttr
from ....auto_parallel.placement import Replicate, Shard
from ....auto_parallel.process_mesh import ProcessMesh
from ....parallel_base import ReduceOp, all_reduce
from ...base.topology import get_hcg


def mp_group():
    """The hybrid topology's mp group, or None without one of more than
    one rank."""
    hcg = get_hcg()
    if hcg is None or hcg.get_model_parallel_world_size() == 1:
        return None
    return hcg.get_model_parallel_group()


def hybrid_process_mesh():
    """The hybrid mesh as a ``ProcessMesh`` (dims dp, pp, sharding, mp,
    sep), or None without a topology."""
    hcg = get_hcg()
    if hcg is None:
        return None
    dm = hcg.mesh
    return ProcessMesh(np.arange(dm.size).reshape(dm.devices.shape),
                       list(dm.axis_names), devices=dm.flat)


def annotate(t, dim):
    """Mark `t` laid out with tensor dim `dim` over mp (None: replicated)
    on the hybrid mesh. Returns `t`."""
    mesh = hybrid_process_mesh()
    if mesh is not None:
        t._dist_attr = DistAttr(mesh, [
            Shard(dim % t.dim()) if n == "mp" and dim is not None
            else Replicate() for n in mesh.dim_names])
    return t


def _relaid(tensor, dim):
    if mp_group() is None:
        return tensor
    return annotate(tensor.view_as(tensor), dim)


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    return tensor


def _c_split(tensor, group=None):
    """Lay the last dim out over mp (values and graph kept)."""
    return _relaid(tensor, -1)


def _c_concat(tensor, group=None):
    """Lay out replicated (values and graph kept)."""
    return _relaid(tensor, None)


def _mp_allreduce(tensor, op=None, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """Lay out replicated: a global tensor holds its reduced value."""
    return _relaid(tensor, None)


def _c_lookup_table(table, index, start_index=0, vocab_size=-1, name=None):
    """Rows of `table` at `index` (the JAX package's lookup)."""
    return table[index.long()]


# ---------------- per-rank autograd functions ----------------

def _chunks(n, k):
    """[start, stop) of each of k equal pieces of n (n % k == 0)."""
    step = n // k
    return [(i * step, (i + 1) * step) for i in range(k)]


class Scatter(torch.autograd.Function):
    """Replicated x -> one copy per rank on its device; the backward sums
    the ranks' gradients (an all-reduce, ``_c_identity``'s backward)."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        parts = [g.clone() for g in grads]
        all_reduce(parts, group=_group_of(parts))
        return parts[0].to(ctx.home), None


class ReduceSum(torch.autograd.Function):
    """Per-rank partials -> their sum (an all-reduce, ``_mp_allreduce``),
    on rank 0's device; the backward hands every rank the gradient."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        work = [p.detach().clone() for p in parts]
        all_reduce(work, group=_group_of(work))
        return work[0]

    @staticmethod
    def backward(ctx, g):
        return tuple(g.to(d) for d in ctx.devices)


class Gather(torch.autograd.Function):
    """Per-rank pieces -> their concatenation along `dim` on rank 0's
    device (an all-gather, ``_c_concat``); the backward splits."""

    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        home = parts[0].device
        return torch.cat([p.detach().to(home) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, g):
        pieces = torch.split(g, ctx.sizes, dim=ctx.dim)
        return (None,) + tuple(p.to(d).contiguous()
                               for p, d in zip(pieces, ctx.devices))


class Split(torch.autograd.Function):
    """x -> its k equal pieces along `dim`, each on its rank's device
    (``_c_split``); the backward gathers the pieces' gradients."""

    @staticmethod
    def forward(ctx, x, dim, devices):
        ctx.dim, ctx.home = dim, x.device
        n = x.shape[dim]
        return tuple(x.narrow(dim, a, b - a).to(d, copy=True).contiguous()
                     for (a, b), d in zip(_chunks(n, len(devices)),
                                          devices))

    @staticmethod
    def backward(ctx, *grads):
        return (torch.cat([g.to(ctx.home) for g in grads], dim=ctx.dim),
                None, None)


def _group_of(parts):
    from ....parallel_base import group_of
    return group_of([p.device for p in parts], "mp")


def vocab_parallel_cross_entropy(logits, label, devices, ignore_index=-100):
    """-log softmax(logits)[label] over the last dim, the vocab split
    over `devices` (one equal piece each): each rank reduces its piece,
    and three all-reduces (max, sum of exponentials, the label's logit)
    combine them. label [...] int; returns the loss [...] (0 where the
    label is ignore_index), in float32 for 16-bit logits."""
    n = len(devices)
    v = logits.shape[-1]
    if v % n:
        raise ValueError(f"vocab {v} does not split over {n} mp ranks")
    parts = Split.apply(logits.float(), -1, devices)
    with torch.no_grad():
        mx = [p.amax(-1) for p in parts]
        all_reduce(mx, op=ReduceOp.MAX, group=_group_of(mx))
    lbl = label.long()
    sums, picks = [], []
    for r, ((lo, hi), p, m) in enumerate(zip(_chunks(v, n), parts, mx)):
        sums.append((p - m[..., None]).exp().sum(-1))
        lr = lbl.to(p.device)
        mine = (lr >= lo) & (lr < hi)
        idx = torch.where(mine, lr - lo, torch.zeros_like(lr))
        got = p.gather(-1, idx[..., None])[..., 0]
        picks.append(torch.where(mine, got - m, torch.zeros_like(got)))
    total = ReduceSum.apply(*sums)
    target = ReduceSum.apply(*picks)
    loss = torch.log(total) - target
    return torch.where(lbl.to(loss.device) == ignore_index,
                       torch.zeros_like(loss), loss)


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False,
                                  ignore_index=-100):
    """Softmax cross-entropy over the vocab (last) dim, shard by shard over
    the mp group (all of it on one device without one). label [..., 1] or
    [...]; returns the loss [..., 1] (and the softmax)."""
    lbl = label[..., 0] if label.dim() == logits.dim() else label
    g = mp_group()
    devices = g.devices if g is not None else [logits.device]
    loss = vocab_parallel_cross_entropy(logits, lbl, devices,
                                        ignore_index)[..., None]
    if return_softmax:
        return loss, torch.softmax(logits.float(), dim=-1)
    return loss


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split`` (``mp_ops.py:706``): build the matching
    parallel layer on `x`'s device and apply it."""
    from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr,
                                       device=x.device)
        return layer(x)
    if operation == "linear":
        if axis == 1:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=x.device)
        else:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=x.device)
        return layer(x)
    raise ValueError(f"unsupported operation {operation}")
