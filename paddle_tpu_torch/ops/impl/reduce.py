"""Reductions, sorting and search: the counterpart of
``paddle_tpu/ops/impl/reduce.py``.

Kept from the JAX package: ``median(mode="avg")`` is the mean of the two
middle values (torch's median is the lower one); ``max``/``min`` return
values only; ``sort``/``argsort``/``topk``/``kthvalue`` break ties by
position (torch's stable sort); ``mode`` returns the most frequent value
with the first index of its first occurrence among the tied counts.
``histogram`` and ``bincount`` compute on the tensor's device
(``bucketize`` + ``bincount``: torch's ``histc`` has no float64 CUDA
kernel and ``histogram`` none on CUDA at all).
"""

from __future__ import annotations

import builtins

import torch

from ...framework import dtype as dtypes
from ..registry import register_op
from ._common import all_dims, axes, inexact, num


def _sum_dtype(x, d):
    if d is not None:
        return d
    if x.dtype == torch.bool or not (x.dtype.is_floating_point
                                     or x.dtype.is_complex):
        return torch.int64
    return None


@register_op("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    return torch.sum(x, all_dims(x, axis), keepdim=keepdim,
                     dtype=_sum_dtype(x, dtypes.convert_dtype(dtype)))


@register_op("mean")
def mean(x, axis=None, keepdim=False, name=None):
    return torch.mean(inexact(x), all_dims(x, axis), keepdim=keepdim)


def _extreme(fn):
    def op(x, axis=None, keepdim=False, name=None):
        if x.dim() == 0:
            return x.clone()
        return fn(x, all_dims(x, axis), keepdim=keepdim)
    return op


for _n, _f in (("max", torch.amax), ("min", torch.amin),
               ("amax", torch.amax), ("amin", torch.amin)):
    _op = _extreme(_f)
    _op.__name__ = _op.__qualname__ = _n
    globals()[_n] = register_op(_n)(_op)
del _n, _f, _op


@register_op("prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = _sum_dtype(x, dtypes.convert_dtype(dtype))
    dims = all_dims(x, axis)
    dims = (dims,) if isinstance(dims, int) else dims
    out = x if d is None else x.to(d)
    for dim in sorted((a % builtins.max(x.dim(), 1) for a in dims), reverse=True):
        out = torch.prod(out, dim, keepdim=keepdim)
    return out


@register_op("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(inexact(x), all_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@register_op("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(inexact(x), all_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _moved(x, axis):
    """x with the reduced dims flattened into the last one, and the shape
    the reduction keeps (keepdim) and drops."""
    dims = all_dims(x, axis)
    dims = (dims,) if isinstance(dims, int) else dims
    dims = sorted(d % builtins.max(x.dim(), 1) for d in dims)
    rest = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    keep = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    return y, keep


def _finish(v, keep, keepdim):
    return v.reshape(keep) if keepdim else v


@register_op("median")
def median(x, axis=None, keepdim=False, mode="avg", name=None):
    if mode == "avg":
        y, keep = _moved(inexact(x), axis)
        srt = torch.sort(y, dim=-1).values
        n = srt.shape[-1]
        mid = (srt[..., (n - 1) // 2] + srt[..., n // 2]) / 2
        return _finish(mid, keep, keepdim)
    # mode="min": the lower median and its index in the original tensor
    if axis is None:
        flat = x.reshape(-1)
        order = torch.argsort(flat, stable=True)
        pos = order[(flat.shape[0] - 1) // 2]
        val, idx = flat[pos], pos.to(torch.int64)
        if keepdim:
            val = val.reshape([1] * x.dim())
            idx = idx.reshape([1] * x.dim())
        return val, idx
    ax = int(axis)
    order = torch.argsort(x, dim=ax, stable=True)
    pos = order.select(ax, (x.shape[ax] - 1) // 2).unsqueeze(ax)
    val = torch.take_along_dim(x, pos, ax)
    if keepdim:
        return val, pos.to(torch.int64)
    return val.squeeze(ax), pos.squeeze(ax).to(torch.int64)


@register_op("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle non-NaN values (NaN where a slice has
    none), as ``jnp.nanmedian``."""
    y, keep = _moved(inexact(x), axis)
    srt = torch.sort(y, dim=-1).values          # NaNs sort last
    cnt = (~torch.isnan(y)).sum(-1, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0)
    mid = (torch.gather(srt, -1, lo) + torch.gather(srt, -1, hi)) / 2
    mid = torch.where(cnt > 0, mid, torch.full_like(mid, float("nan")))
    return _finish(mid.squeeze(-1), keep, keepdim)


@register_op("nansum")
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = _sum_dtype(x, dtypes.convert_dtype(dtype))
    return torch.nansum(x if d is None else x.to(d), all_dims(x, axis),
                        keepdim=keepdim)


@register_op("nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(inexact(x), all_dims(x, axis), keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation):
    x = inexact(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        return fn(x.reshape(-1), qt, dim=0, keepdim=False,
                  interpolation=interpolation) if not keepdim else \
            fn(x.reshape(-1), qt, dim=0, keepdim=False,
               interpolation=interpolation).reshape(
                qt.shape + (1,) * x.dim())
    a = axes(axis)
    if isinstance(a, int):
        return fn(x, qt, dim=a, keepdim=keepdim,
                  interpolation=interpolation)
    y, keep = _moved(x, a)
    out = fn(y, qt, dim=-1, keepdim=False, interpolation=interpolation)
    return out.reshape(qt.shape + tuple(keep)) if keepdim else out


@register_op("quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


@register_op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


@register_op("all")
def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.all(x, all_dims(x, axis), keepdim=keepdim) if x.dim() \
        else x.bool().clone()


@register_op("any")
def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.any(x, all_dims(x, axis), keepdim=keepdim) if x.dim() \
        else x.bool().clone()


@register_op("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return torch.sum(x != 0, all_dims(x, axis), keepdim=keepdim,
                     dtype=torch.int64)


@register_op("logsumexp")
def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(inexact(x), all_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    d = dtypes.convert_dtype(dtype)
    if axis is None:
        out = fn(x.reshape(-1), 0)
        if keepdim:
            out = out.reshape([1] * x.dim())
        return out.to(d)
    return fn(x, int(axis), keepdim=keepdim).to(d)


@register_op("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@register_op("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@register_op("argsort")
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """Stable ascending order; descending is its reverse (ties last
    position first), as ``jnp.argsort`` gives it."""
    idx = torch.sort(x, dim=axis, stable=True).indices
    return torch.flip(idx, (axis,)) if descending else idx


@register_op("sort")
def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(x, dim=axis, descending=descending,
                      stable=True).values


@register_op("topk")
def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    axis = -1 if axis is None else int(axis)
    idx = torch.sort(x, dim=axis, descending=largest,
                     stable=True).indices.narrow(axis, 0, int(num(k)))
    return torch.take_along_dim(x, idx, axis), idx


@register_op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    srt = torch.sort(x, dim=axis, stable=True)
    val = srt.values.select(axis, int(k) - 1)
    idx = srt.indices.select(axis, int(k) - 1)
    if keepdim:
        val, idx = val.unsqueeze(axis), idx.unsqueeze(axis)
    return val, idx


@register_op("mode")
def mode(x, axis=-1, keepdim=False, name=None):
    moved = torch.movedim(x, axis, -1)
    counts = (moved[..., :, None] == moved[..., None, :]).sum(-1)
    idx = torch.argmax(counts, dim=-1)      # the first of the tied counts
    vals = torch.gather(moved, -1, idx[..., None])[..., 0]
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def edges(lo, hi, bins, x):
    """bins + 1 edges over [lo, hi] in float64 on x's device, the ends
    exact; lo and hi are numbers or 0-dim tensors there (a range read
    from the data never leaves the device). A flat range widens by 0.5
    either side, as numpy's."""
    lo, hi = (torch.as_tensor(v, dtype=torch.float64, device=x.device)
              for v in (lo, hi))
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    t = torch.arange(int(bins) + 1, dtype=torch.float64,
                     device=x.device) / int(bins)
    return torch.lerp(lo.expand(t.shape), hi.expand(t.shape), t)


def _hist1d(v, edges, w):
    """Counts (or weight sums) of `v` in the bins of `edges`; the last
    bin is closed, as numpy's."""
    nb = edges.shape[0] - 1
    vd = v.to(torch.float64)
    idx = torch.bucketize(vd, edges, right=True) - 1
    idx = torch.where(vd == edges[-1], nb - 1, idx)
    inside = (idx >= 0) & (idx < nb)
    idx = torch.where(inside, idx, nb)
    wts = None if w is None else torch.where(inside, w.reshape(-1), 0)
    return torch.bincount(idx, weights=wts, minlength=nb + 1)[:nb]


@register_op("histogram")
def histogram(x, bins=100, min=0, max=0, weight=None, density=False,  # noqa: A002
              name=None):
    v = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = v.min(), v.max()
    else:
        lo, hi = num(min), num(max)
    e = edges(lo, hi, bins, x)
    hist = _hist1d(v, e, weight)
    if density:
        width = e[1:] - e[:-1]
        return (hist / hist.sum() / width).to(inexact(x).dtype)
    if weight is not None:
        return hist.to(weight.dtype)
    return hist.to(torch.int64)


@register_op("histogramdd")
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    n, d = x.shape[0], x.shape[-1]
    pts = x.reshape(n, d)
    nbins = [int(bins)] * d if isinstance(bins, int) else \
        [int(b) for b in bins]
    all_edges = []
    flat = torch.zeros(n, dtype=torch.int64, device=x.device)
    inside = torch.ones(n, dtype=torch.bool, device=x.device)
    for i in range(d):
        col = pts[:, i].contiguous()
        if ranges is not None:
            # pairs per dim, or Paddle's flat [lo0, hi0, lo1, hi1, ...]
            lo, hi = ranges[i] if isinstance(ranges[0], (list, tuple)) \
                else (ranges[2 * i], ranges[2 * i + 1])
        else:
            lo, hi = col.min(), col.max()
        e = edges(lo, hi, nbins[i], x)
        all_edges.append(e.to(inexact(x).dtype))
        cd = col.to(torch.float64)
        idx = torch.bucketize(cd, e, right=True) - 1
        idx = torch.where(cd == e[-1], nbins[i] - 1, idx)
        inside &= (idx >= 0) & (idx < nbins[i])
        flat = flat * nbins[i] + torch.clamp(idx, 0, nbins[i] - 1)
    total = 1
    for b in nbins:
        total *= b
    flat = torch.where(inside, flat, total)
    w = None if weights is None else torch.where(
        inside, weights.reshape(-1).to(torch.float64), 0)
    hist = torch.bincount(flat, weights=w, minlength=total + 1)[:total]
    hist = hist.reshape(nbins)
    if not density:
        return (hist.to(torch.int64 if weights is None else
                        weights.dtype),) + tuple(all_edges)
    hist = hist.to(torch.float64)
    if density:
        vol = torch.ones((), dtype=torch.float64, device=x.device)
        for i, e in enumerate(all_edges):
            shape = [1] * d
            shape[i] = -1
            vol = vol * (e[1:] - e[:-1]).to(torch.float64).reshape(shape)
        hist = hist / hist.sum() / vol
    return (hist.to(inexact(x).dtype),) + tuple(all_edges)


@register_op("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x, weights=weights, minlength=int(minlength))
