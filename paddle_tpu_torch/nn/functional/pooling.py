"""Pooling: the counterparts of ``paddle_tpu/nn/functional/pooling.py`` —
average, max and adaptive pools in 1-3 dims, ``lp_pool2d``,
``max_unpool2d``/``3d`` and ``fractional_max_pool2d``/``3d``.

The windows are the JAX op's ``lax.reduce_window`` windows: the input is
padded by ``_pool_pads`` (an int or one per dim, symmetric; "SAME" /
"VALID" as for the convolutions; ``ceil_mode`` adds stride - 1 after),
max pools with -inf, sums with 0, and then pooled with no padding of
torch's own (torch's ceil_mode and count_include_pad differ). Average
pools divide by the window's size, or, with ``exclusive=True`` (the
default: torch's ``count_include_pad=False``) and padding, by the count
of the window's input elements; ``divisor_override`` replaces the divisor.
``return_mask`` gives the flat index of each window's first maximum over
the input's spatial dims (not with ceil_mode or a string padding, as in
JAX). Adaptive pools take windows [floor(i in / out), ceil((i + 1) in /
out)), as JAX's; the adaptive max pools' return_mask is taken and
ignored, as in JAX. ``fractional_max_pool*`` without ``random_u`` draws it
from the CPU generator of ``framework.random`` (seeded by ``seed``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework.random import default_generator
from ...ops.registry import register_op
from .conv import _flat_pads

_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_ADAPTIVE_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                 3: TF.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
                 3: TF.adaptive_max_pool3d}


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else [v[0]] * n))
    return tuple(int(v) for _ in range(n))


def _pool_pads(padding, n, ceil_mode, in_spatial, kernel, strides):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * n
        else:
            pads = []
            for i in range(n):
                out = -(-in_spatial[i] // strides[i])
                total = max(0, (out - 1) * strides[i] + kernel[i] -
                            in_spatial[i])
                pads.append((total // 2, total - total // 2))
            return pads
    else:
        pads = [(x, x) for x in _tup(padding, n)]
    if ceil_mode:
        pads = [(lo, hi + strides[i] - 1) for i, (lo, hi) in enumerate(pads)]
    return pads


def _geometry(x, n, kernel_size, stride, padding, ceil_mode, data_format):
    """(x channel-first, kernel, strides, pads, channel_last)."""
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = torch.movedim(x, -1, 1)
    kernel = _tup(kernel_size, n)
    strides = _tup(stride if stride is not None else kernel_size, n)
    pads = _pool_pads(padding, n, ceil_mode, x.shape[2:], kernel, strides)
    return x, kernel, strides, pads, channel_last


def _back(out, channel_last):
    return torch.movedim(out, 1, -1) if channel_last else out


def _window_mean(x, n, kernel, strides, pads):
    """Window sums over the zero-padded x, divided by the window size."""
    xp = TF.pad(x, _flat_pads(pads)) if any(p != (0, 0) for p in pads) \
        else x
    return _AVG[n](xp, kernel, strides)


def _avg_pool(x, n, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    x, kernel, strides, pads, cl = _geometry(x, n, kernel_size, stride,
                                             padding, ceil_mode, data_format)
    mean = _window_mean(x, n, kernel, strides, pads)
    if divisor_override:
        out = mean * (math.prod(kernel) / divisor_override)
    elif exclusive and any(p != (0, 0) for p in pads):
        out = mean / _window_mean(torch.ones_like(x), n, kernel, strides,
                                  pads)
    else:
        out = mean
    return _back(out, cl)


def _max_pool(x, n, kernel_size, stride, padding, ceil_mode, data_format):
    x, kernel, strides, pads, cl = _geometry(x, n, kernel_size, stride,
                                             padding, ceil_mode, data_format)
    if any(p != (0, 0) for p in pads):
        x = TF.pad(x, _flat_pads(pads), value=float("-inf"))
    return _back(_MAX[n](x, kernel, strides), cl)


def _pool_indices(x, n, kernel_size, stride, padding, ceil_mode=False):
    """Flat index (over x's spatial dims) of each window's first maximum;
    x channel-first."""
    if ceil_mode or isinstance(padding, str):
        raise NotImplementedError(
            "return_mask with ceil_mode/string padding is unsupported "
            "(the mask indices would not match the padded output grid)")
    kernel = _tup(kernel_size, n)
    strides = _tup(stride if stride is not None else kernel_size, n)
    pad = _tup(padding, n)
    xp = TF.pad(x, _flat_pads([(p, p) for p in pad]), value=float("-inf"))
    _, idx = _MAX[n](xp, kernel, strides, return_indices=True)
    padded = xp.shape[2:]
    flat = torch.zeros_like(idx)
    rem = idx
    scale = 1
    for d in range(n - 1, -1, -1):
        coord = rem % padded[d] - pad[d]
        rem = rem // padded[d]
        flat = flat + coord * scale
        scale *= x.shape[2 + d]
    return flat.to(torch.int64)


@register_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _avg_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, "NCL")


@register_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


@register_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def _max_pool_op(x, n, kernel_size, stride, padding, return_mask,
                 ceil_mode, data_format):
    out = _max_pool(x, n, kernel_size, stride, padding, ceil_mode,
                    data_format)
    if return_mask:
        return out, _pool_indices(x, n, kernel_size, stride, padding,
                                  ceil_mode)
    return out


@register_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool_op(x, 1, kernel_size, stride, padding, return_mask,
                        ceil_mode, "NCL")


@register_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool_op(x, 2, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format)


@register_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool_op(x, 3, kernel_size, stride, padding, return_mask,
                        ceil_mode, data_format)


def _adaptive_pool(x, output_size, n, table, data_format):
    channel_last = not data_format.startswith("NC")
    if channel_last:
        x = torch.movedim(x, -1, 1)
    out = _tup(output_size, n) if not isinstance(output_size, (list, tuple)) \
        else tuple(output_size)
    out = tuple(x.shape[2 + i] if out[i] is None else int(out[i])
                for i in range(n))
    res = table[n](x, out)
    return _back(res, channel_last)


@register_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, _ADAPTIVE_AVG, "NCL")


@register_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, _ADAPTIVE_AVG, data_format)


@register_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, _ADAPTIVE_AVG, data_format)


@register_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, _ADAPTIVE_MAX, "NCL")


@register_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, _ADAPTIVE_MAX, "NCHW")


@register_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, _ADAPTIVE_MAX, "NCDHW")


@register_op("lp_pool2d")
def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """(sum over each window of |x|^p)^(1/p)."""
    x, kernel, strides, pads, cl = _geometry(x, 2, kernel_size, stride,
                                             padding, ceil_mode, data_format)
    summed = _window_mean(torch.pow(x.abs(), norm_type), 2, kernel, strides,
                          pads) * math.prod(kernel)
    return _back(torch.pow(summed, 1.0 / norm_type), cl)


def _unpool(x, indices, spatial_out):
    n, c = x.shape[:2]
    out = x.new_zeros((n, c, math.prod(spatial_out)))
    out.scatter_(2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(spatial_out))


@register_op("max_unpool2d")
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter each pooled value to the flat h*w offset recorded by
    ``max_pool2d(return_mask=True)``; zeros elsewhere."""
    ks = _tup(kernel_size, 2)
    st = _tup(stride if stride is not None else kernel_size, 2)
    pd = _tup(padding, 2)
    if output_size is None:
        size = [(x.shape[2 + i] - 1) * st[i] + ks[i] - 2 * pd[i]
                for i in range(2)]
    else:
        size = list(output_size[-2:])
    return _unpool(x, indices, size)


@register_op("max_unpool3d")
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    ks = _tup(kernel_size, 3)
    st = _tup(stride if stride is not None else kernel_size, 3)
    pd = _tup(padding, 3)
    if output_size is None:
        size = [(x.shape[2 + i] - 1) * st[i] + ks[i] - 2 * pd[i]
                for i in range(3)]
    else:
        size = list(output_size[-3:])
    return _unpool(x, indices, size)


def _fractional_bounds(n_in, n_out, kernel, u):
    """Pooling regions of Graham's fractional max pooling: start_i =
    floor(alpha (i + u)); [start, next start), or [start, start + kernel)
    with an overlapping kernel_size."""
    alpha = n_in / n_out
    idx = np.floor(alpha * (np.arange(n_out + 1) + u)).astype(np.int64)
    idx = np.clip(idx, 0, n_in)
    starts = idx[:-1]
    if kernel:
        ends = np.minimum(starts + kernel, n_in)
    else:
        ends = np.maximum(idx[1:], starts + 1)
    return starts, ends


def _window_gather(x, axis, starts, ends):
    """The regions along `axis` padded to the longest (repeating their
    last index): (windows with a new axis after `axis`, the indices)."""
    kmax = int((ends - starts).max())
    idx = starts[:, None] + np.arange(kmax)[None, :]
    idx = np.minimum(idx, (ends - 1)[:, None])
    g = torch.index_select(x, axis, torch.as_tensor(
        idx.reshape(-1), device=x.device))
    shp = tuple(x.shape[:axis]) + (len(starts), kmax) + \
        tuple(x.shape[axis + 1:])
    return g.reshape(shp), idx


def _fractional_pool(x, nsp, output_size, kernel_size, random_u,
                     return_mask=False):
    sp = x.shape[2:]
    if isinstance(output_size, int):
        output_size = (output_size,) * nsp
    ks = ((kernel_size,) * nsp if isinstance(kernel_size, int)
          else tuple(kernel_size) if kernel_size else (None,) * nsp)
    if random_u is None:
        u = float(torch.rand((), generator=default_generator("cpu")))
    else:
        u = float(random_u)
    bounds = [_fractional_bounds(sp[d], output_size[d], ks[d], u)
              for d in range(nsp)]
    if not return_mask:
        out = x
        for d in range(nsp):
            win, _ = _window_gather(out, 2 + d, *bounds[d])
            out = win.amax(3 + d)
        return out
    if nsp != 2:
        raise NotImplementedError(
            "fractional_max_pool3d(return_mask=True) is not implemented")
    w = x.shape[3]
    oh, ow = output_size
    win_w, idx_w = _window_gather(x, 3, *bounds[1])        # N,C,H,ow,kw
    max_w, arg_w = win_w.max(4)
    idx_w = torch.as_tensor(idx_w, device=x.device)
    col = idx_w[torch.arange(ow, device=x.device)[None, None, None, :],
                arg_w]                                      # N,C,H,ow
    win_h, idx_h = _window_gather(max_w, 2, *bounds[0])    # N,C,oh,kh,ow
    out, arg_h = win_h.max(3)
    idx_h = torch.as_tensor(idx_h, device=x.device)
    row = idx_h[torch.arange(oh, device=x.device)[None, None, :, None],
                arg_h]
    col_sel = torch.gather(col, 2, row)
    return out, (row * w + col_sel).to(torch.int32)


@register_op("fractional_max_pool2d")
def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool(x, 2, output_size, kernel_size, random_u,
                            return_mask)


@register_op("fractional_max_pool3d")
def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool(x, 3, output_size, kernel_size, random_u,
                            return_mask)
