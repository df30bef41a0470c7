"""Convolutions: the counterparts of ``paddle_tpu/nn/functional/conv.py`` —
``conv1d``/``2d``/``3d`` and their transposes.

The products are ``torch.nn.functional.conv*`` (cuDNN on the card): the
JAX package computes them with ``lax.conv_general_dilated``, outside any
Pallas kernel. The padding rules are the JAX op's (``_padding``): an int
or one per dim (symmetric), ``[before0, after0, before1, ...]``
(per side), "VALID", or "SAME" (out = ceil(in / stride), the odd pixel
after). Weights are ``[out, in/groups, *k]``; a transpose takes
``[in, out/groups, *k]``. Channel-last formats (NLC, NHWC, NDHWC) compute
channel-first and move the channels back.

A transposed conv is the gradient of the conv with the same padding: a
conv over the input dilated by the stride, with the kernel flipped and its
channel axes swapped per group, padded by (k_eff - 1 - before, k_eff - 1
- after + output_padding). ``torch.nn.functional.conv_transpose*``
computes exactly that when the padding is symmetric and output_padding is
below the stride or the dilation; otherwise the dilated conv is spelled
out (``_conv_transpose_dilated``; negative pads crop). output_size pads
the result at the end up to that size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops.registry import register_op

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 2 * n:
            return v
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _padding(padding, n, strides, dilations, kernel, in_spatial):
    """[(before, after)] per spatial dim."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            pads = []
            for i in range(n):
                out = -(-in_spatial[i] // strides[i])
                eff_k = (kernel[i] - 1) * dilations[i] + 1
                total = max(0, (out - 1) * strides[i] + eff_k -
                            in_spatial[i])
                pads.append((total // 2, total - total // 2))
            return pads
        raise ValueError(f"unknown padding {padding}")
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(p, p) for p in _tuplize(padding, n)]


def _flat_pads(pads):
    """[(before, after)] per spatial dim -> torch's pad list (last dim
    first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv_transpose_dilated(x, weight, strides, dilations, groups, pads,
                            opad, n):
    kernel = weight.shape[2:]
    eff_k = [(kernel[i] - 1) * dilations[i] + 1 for i in range(n)]
    tpads = [(eff_k[i] - 1 - pads[i][0], eff_k[i] - 1 - pads[i][1] + opad[i])
             for i in range(n)]
    w = torch.flip(weight, dims=tuple(range(2, 2 + n)))
    if groups > 1:
        ic, ocg = w.shape[0], w.shape[1]
        w = w.reshape((groups, ic // groups, ocg) + tuple(w.shape[2:]))
        w = w.transpose(1, 2).reshape((groups * ocg, ic // groups) +
                                      tuple(w.shape[3:]))
    else:
        w = w.transpose(0, 1)
    if any(s > 1 for s in strides):
        size = [(x.shape[2 + i] - 1) * strides[i] + 1 for i in range(n)]
        xd = x.new_zeros(tuple(x.shape[:2]) + tuple(size))
        xd[(slice(None), slice(None)) +
           tuple(slice(None, None, s) for s in strides)] = x
        x = xd
    x = TF.pad(x, _flat_pads(tpads))
    return _CONV[n](x, w, None, 1, 0, dilations, groups)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format, transpose=False, output_padding=0, output_size=None):
    channel_last = not data_format.startswith("NC")
    strides = _tuplize(stride, n)
    dilations = _tuplize(dilation, n)
    kernel = weight.shape[2:]
    in_spatial = x.shape[1:-1] if channel_last else x.shape[2:]
    pads = _padding(padding, n, strides, dilations, kernel, in_spatial)
    if channel_last:
        x = torch.movedim(x, -1, 1)
    symmetric = all(lo == hi for lo, hi in pads)
    if not transpose:
        if symmetric:
            out = _CONV[n](x, weight, None, strides, [lo for lo, _ in pads],
                           dilations, groups)
        else:
            out = _CONV[n](TF.pad(x, _flat_pads(pads)), weight, None,
                           strides, 0, dilations, groups)
    else:
        opad = _tuplize(output_padding, n)
        if symmetric and all(o < max(s, d) for o, s, d in
                             zip(opad, strides, dilations)):
            out = _CONV_T[n](x, weight, None, strides,
                             [lo for lo, _ in pads], opad, groups,
                             dilations)
        else:
            out = _conv_transpose_dilated(x, weight, strides, dilations,
                                          groups, pads, opad, n)
        if output_size is not None:
            target = _tuplize(output_size, n)
            extra = [t - c for t, c in zip(target, out.shape[2:])]
            out = TF.pad(out, _flat_pads([(0, e) for e in extra]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return torch.movedim(out, 1, -1) if channel_last else out


@register_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 "NCL" if data_format == "NCL" else "NLC")


@register_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


@register_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


@register_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format, transpose=True, output_padding=output_padding,
                 output_size=output_size)


@register_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format, transpose=True, output_padding=output_padding,
                 output_size=output_size)


@register_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format, transpose=True, output_padding=output_padding,
                 output_size=output_size)
