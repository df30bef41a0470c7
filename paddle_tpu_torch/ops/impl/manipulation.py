"""Shape, layout, indexing and scatter ops: the counterpart of
``paddle_tpu/ops/impl/manipulation.py``, with ``getitem`` / ``setitem``
as functions (``setitem`` returns a new tensor, as the JAX op does).

Paddle semantics kept where a torch name means something else:
``split(num_or_sections)`` takes a count or a list of sizes (-1 inferred);
``gather`` takes whole slices along an axis (``jnp.take``);
``scatter(overwrite=False)`` zeroes the indexed rows and then adds;
``tile`` is ``torch.tile``; ``pad`` reads Paddle's pad list (per-dim
pairs over every dim, or pairs from the last spatial dim backwards).

``masked_select``, ``nonzero``, ``unique`` and ``unique_consecutive``
have a data-dependent shape; they compute on the tensor's device (the
JAX package reads them back to the host).
"""

from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...framework import dtype as dtypes
from ..registry import register_op
from ._common import as_tensor, axes, both, shape_of


def _tensors(xs):
    """A list of tensors (and arrays or numbers, made tensors)."""
    dev = next((t.device for t in xs if isinstance(t, torch.Tensor)), None)
    return [t if isinstance(t, torch.Tensor) else as_tensor(t, device=dev)
            for t in xs]


@register_op("reshape", inplace=True)
def reshape(x, shape, name=None):
    return torch.reshape(x, shape_of(shape))


@register_op("view")
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple, torch.Tensor)):
        return x.reshape(shape_of(shape_or_dtype))
    return x.view(dtypes.convert_dtype(shape_or_dtype))


@register_op("view_as")
def view_as(x, other, name=None):
    return x.reshape(other.shape)


@register_op("transpose")
def transpose(x, perm=None, name=None):
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*shape_of(perm))


@register_op("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, axes(source), axes(destination))


@register_op("swapaxes")
def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


@register_op("t")
def t(x, name=None):
    return x if x.dim() < 2 else x.t()


@register_op("cast", amp=False)
def cast(x, dtype):
    return x.to(dtypes.convert_dtype(dtype))


@register_op("concat")
def concat(x, axis=0, name=None):
    return torch.cat(_tensors(x), dim=int(axis))


@register_op("stack")
def stack(x, axis=0, name=None):
    return torch.stack(_tensors(x), dim=int(axis))


@register_op("split")
def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis)
    n = x.shape[axis]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"split: dim {axis} of size {n} does not "
                             f"divide into {num_or_sections} equal parts")
        return tuple(torch.split(x, n // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections = [n - known if s == -1 else s for s in sections]
    return tuple(torch.split(x, sections, dim=axis))


@register_op("chunk")
def chunk(x, chunks, axis=0, name=None):
    return split.__wrapped__(x, int(chunks), axis)


@register_op("unbind")
def unbind(x, axis=0, name=None):
    return tuple(torch.unbind(x, int(axis)))


@register_op("unstack")
def unstack(x, axis=0, num=None, name=None):
    return tuple(torch.unbind(x, int(axis)))


@register_op("squeeze", inplace=True)
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    a = axes(axis)
    a = (a,) if isinstance(a, int) else a
    a = tuple(d for d in a if x.shape[d] == 1)
    return torch.squeeze(x, a) if a else x


@register_op("unsqueeze", inplace=True)
def unsqueeze(x, axis, name=None):
    a = axes(axis)
    a = (a,) if isinstance(a, int) else a
    nd = x.dim() + len(a)
    out_shape, src = [], iter(x.shape)
    dims = {d % nd for d in a}
    for i in range(nd):
        out_shape.append(1 if i in dims else next(src))
    return x.reshape(out_shape)


@register_op("flatten", inplace=True)
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@register_op("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(x, shape_of(repeat_times))


@register_op("expand")
def expand(x, shape, name=None):
    shape = shape_of(shape)
    xshape = [1] * (len(shape) - x.dim()) + list(x.shape)
    out = [xs if s == -1 else s for s, xs in zip(shape, xshape)]
    return x.reshape(xshape).expand(out)


@register_op("expand_as")
def expand_as(x, y, name=None):
    return x.expand(y.shape)


@register_op("broadcast_to")
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, shape_of(shape))


@register_op("broadcast_tensors")
def broadcast_tensors(inputs, name=None):
    return tuple(torch.broadcast_tensors(*_tensors(inputs)))


@register_op("flip")
def flip(x, axis, name=None):
    a = axes(axis)
    return torch.flip(x, (a,) if isinstance(a, int) else a)


@register_op("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):  # noqa: A002
    return torch.rot90(x, k, list(axes))


@register_op("roll")
def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@register_op("gather")
def gather(x, index, axis=0, name=None):
    if isinstance(index, torch.Tensor) and index.dim() > 1:
        index = index.reshape(-1)
    index = torch.as_tensor(index, device=x.device)
    return torch.index_select(x, int(axis), index.reshape(-1)).reshape(
        x.shape[:int(axis) % x.dim()] + index.shape
        + x.shape[int(axis) % x.dim() + 1:])


def _nd(index):
    """An [..., k] index tensor as a tuple of k index tensors."""
    return tuple(torch.movedim(index, -1, 0))


@register_op("gather_nd")
def gather_nd(x, index, name=None):
    return x[_nd(index)]


@register_op("scatter", inplace=True)
def scatter(x, index, updates, overwrite=True, name=None):
    index = index.reshape(-1)
    if overwrite:
        return x.index_put((index,), updates.to(x.dtype))
    zeroed = x.index_put((index,), torch.zeros_like(updates, dtype=x.dtype))
    return zeroed.index_put((index,), updates.to(x.dtype), accumulate=True)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(_nd(index), updates.to(x.dtype), accumulate=True)


@register_op("scatter_nd")
def scatter_nd(index, updates, shape, name=None):
    z = torch.zeros(shape_of(shape), dtype=updates.dtype,
                    device=updates.device)
    return z.index_put(_nd(index), updates, accumulate=True)


@register_op("index_select")
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), index.reshape(-1))


@register_op("index_sample")
def index_sample(x, index, name=None):
    return torch.gather(x, 1, index)


@register_op("index_add", inplace=True)
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, int(axis), index, value)


@register_op("index_put", inplace=True)
def index_put(x, indices, value, accumulate=False, name=None):
    value = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=x.dtype, device=x.device)
    return x.index_put(tuple(indices), value, accumulate=accumulate)


@register_op("index_fill", inplace=True)
def index_fill(x, index, axis, value, name=None):
    return torch.index_fill(x, int(axis), index, value)


@register_op("masked_select")
def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask)


@register_op("masked_fill", inplace=True)
def masked_fill(x, mask, value, name=None):
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    return torch.masked_fill(x, mask, value)


@register_op("masked_scatter")
def masked_scatter(x, mask, value, name=None):
    return torch.masked_scatter(x, mask.expand(x.shape), value.to(x.dtype))


@register_op("where")
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return tuple(i for i in torch.nonzero(condition, as_tuple=True))
    x, y = both(x, y)
    return torch.where(condition, x, y)


@register_op("nonzero")
def nonzero(x, as_tuple=False, name=None):
    if as_tuple:
        return tuple(i[:, None] for i in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@register_op("take_along_axis")
def take_along_axis(x, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(x, indices, int(axis))


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}


@register_op("put_along_axis", inplace=True)
def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    axis = int(axis) % x.dim()
    values = values if isinstance(values, torch.Tensor) else \
        torch.tensor(values, device=x.device)
    values = torch.broadcast_to(values.to(x.dtype), indices.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    return torch.scatter_reduce(x, axis, indices, values, _REDUCE[reduce],
                                include_self=True)


@register_op("slice")
def slice(x, axes, starts, ends, name=None):  # noqa: A001
    idx = [builtins.slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[int(ax)] = builtins.slice(int(s), int(e))
    return x[tuple(idx)]


def _strided(x, axes, starts, ends, strides):
    """x[starts:ends:strides] along `axes`; negative strides walk back,
    as numpy's slices do."""
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax, s, e, st = int(ax), int(s), int(e), int(st)
        n = x.shape[ax]
        idx = torch.tensor(range(n)[builtins.slice(s, e, st)],
                           dtype=torch.int64, device=x.device) \
            if st < 0 else None
        if idx is None:
            x = x[(builtins.slice(None),) * ax + (builtins.slice(s, e, st),)]
        else:
            x = torch.index_select(x, ax, idx)
    return x


@register_op("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided(x, axes, starts, ends, strides)


@register_op("crop")
def crop(x, shape=None, offsets=None, name=None):
    offsets = offsets or [0] * x.dim()
    shape = shape or list(x.shape)
    return x[tuple(builtins.slice(int(o), int(o) + int(s))
                   for o, s in zip(offsets, shape))]


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


@register_op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        name=None):
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    width = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        # full-rank: [before, after] per dim, in dim order
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # pairs from the last spatial dim backwards
        k = len(pad) // 2
        spatial = list(range(nd - k, nd)) if data_format in (
            "NCHW", "NCL", "NCDHW") else list(range(1, 1 + k))
        for j, d in enumerate(reversed(spatial)):
            width[d] = (pad[2 * j], pad[2 * j + 1])
    if mode == "constant":
        flat = [p for d in reversed(range(nd)) for p in width[d]]
        return F.pad(x, flat, "constant", value)
    # F.pad's non-constant modes pad the trailing dims of a batched tensor:
    # move the padded dims last, add two leading dims
    padded = [d for d in range(nd) if width[d] != (0, 0)]
    if not padded:
        return x.clone()
    rest = [d for d in range(nd) if d not in padded]
    y = x.permute(*rest, *padded)
    lead = y.shape[:len(rest)]
    y = y.reshape((1, math.prod(lead)) + tuple(y.shape[len(rest):]))
    flat = [p for d in reversed(padded) for p in width[d]]
    y = F.pad(y, flat, _PAD_MODES[mode])
    y = y.reshape(tuple(lead) + tuple(y.shape[2:]))
    inv = np.argsort(rest + padded).tolist()
    return y.permute(*inv)


@register_op("getitem")
def getitem(x, idx):
    return x[idx]


@register_op("setitem")
def setitem(x, idx, v):
    out = x.clone()
    out[idx] = v.to(x.dtype) if isinstance(v, torch.Tensor) else v
    return out


@register_op("numel")
def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@register_op("shape")
def shape(x, name=None):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@register_op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, axis)


@register_op("unique")
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique``: sorted values, and the first index of each,
    the inverse and the counts as asked."""
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        flat_inv = inverse.reshape(-1)
        pos = torch.arange(flat_inv.numel(), device=x.device)
        first = torch.full((vals.shape[axis] if axis is not None
                            else vals.numel(),), flat_inv.numel(),
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(0, flat_inv, pos, "amin"))
    if return_inverse:
        out.append(inverse.reshape(x.shape) if axis is None else inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


@register_op("unique_consecutive")
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    flat = x.reshape(-1) if axis is None else x
    vals, inverse, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True)
    out = [vals]
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


@register_op("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@register_op("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.searchsorted(sorted_sequence, x, out_int32=out_int32,
                              right=right)


@register_op("as_complex")
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@register_op("as_real")
def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@register_op("tensordot")
def tensordot(x, y, axes=2, name=None):  # noqa: A002
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and all(
            isinstance(a, int) for a in axes):
        axes = ([axes[0]], [axes[1]])
    return torch.tensordot(x, y, dims=axes)


@register_op("atleast_1d")
def atleast_1d(*xs, name=None):
    out = [torch.atleast_1d(t) for t in _tensors(xs)]
    return out[0] if len(out) == 1 else out


def _stack_op(name, fn):
    def op(x, name=None):
        return fn(_tensors(x))
    op.__name__ = op.__qualname__ = name
    globals()[name] = register_op(name)(op)


for _n, _f in (("vstack", torch.vstack), ("hstack", torch.hstack),
               ("dstack", torch.dstack),
               ("column_stack", torch.column_stack),
               ("row_stack", torch.vstack)):
    _stack_op(_n, _f)
del _n, _f
