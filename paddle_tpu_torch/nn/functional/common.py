"""Common functionals: the counterparts of
``paddle_tpu/nn/functional/common.py`` — ``linear``, the dropouts,
``embedding``, ``one_hot``, ``label_smooth``, ``cosine_similarity``,
``normalize``, the pixel and channel shuffles, ``unfold`` / ``fold``,
``interpolate`` / ``upsample``, ``affine_grid`` / ``grid_sample``,
``bilinear`` and ``temporal_shift``.

``interpolate`` reproduces ``jax.image.resize``, which the JAX op calls,
not ``torch.nn.functional.interpolate``:

- "nearest" samples input index floor((i + 0.5) * in / out) (half-pixel
  centers, the offsets in float32);
- "linear"/"bilinear"/"trilinear" (and "area", which JAX maps to linear)
  and "bicubic" (the Keys kernel, a = -0.5) contract each resized dim
  with a weight matrix [in, out] (``_resize_weights``): sample points at
  (i + 0.5) / scale - 0.5, the kernel widened by 1 / scale on a
  DOWNSCALE (antialiasing, which torch's bilinear leaves out unless asked),
  each column normalized to sum 1, and columns whose sample falls outside
  the input zeroed; the weights are computed in float64 and cast to x's
  type, as JAX computes them with x64 on;
- align_corners (not for nearest) maps output 0 and out - 1 onto input 0
  and in - 1 (``jax.image.scale_and_translate``'s scale and translation,
  whose weights JAX computes in float32, and so does the port) and
  resizes every spatial dim, equal sizes too.

``grid_sample`` is ``jax.scipy.ndimage.map_coordinates`` of order 1
(bilinear) or 0 (nearest, rounding half away from zero) per image and
channel, with its "constant" (zeros), "nearest" (border) and "mirror"
(reflection) index rules. Random functionals draw from the input
device's default generator (``framework.random``) or ``generator=``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...framework.random import default_generator
from ...ops.registry import OP_TABLE, register_op


@register_op("linear")
def linear(x, weight, bias=None, name=None):
    """y = x @ weight (+ bias); weight [in, out] (paddle's layout)."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _keep_mask(shape, p, x, generator):
    gen = generator if generator is not None else default_generator(x.device)
    return torch.rand(shape, generator=gen, device=x.device) < 1.0 - p


@register_op("dropout")
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Zero each element (or each slice along `axis`, which shares one
    draw) with probability p. "upscale_in_train" divides the kept values
    by 1 - p in training; "downscale_in_infer" keeps them as they are and
    multiplies by 1 - p outside training."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    else:
        shape = x.shape
    keep = _keep_mask(shape, p, x, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def _channel_dropout(x, p, data_format, spatial, generator):
    if data_format.startswith("NC"):
        shape = tuple(x.shape[:2]) + (1,) * spatial
    else:
        shape = (x.shape[0],) + (1,) * spatial + (x.shape[-1],)
    keep = _keep_mask(shape, p, x, generator)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


@register_op("dropout2d")
def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """Zero whole channels of an [N, C, H, W] (or NHWC) input."""
    if not training or p == 0.0:
        return x
    return _channel_dropout(x, p, data_format, 2, generator)


@register_op("dropout3d")
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    if not training or p == 0.0:
        return x
    return _channel_dropout(x, p, data_format, 3, generator)


@register_op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout: dropped values take -alpha * scale, then
    an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep_mask(x.shape, p, x, generator)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


@register_op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of weight at ids x; with padding_idx, those positions read
    their row and pass it no gradient."""
    out = weight[x]
    if padding_idx is None:
        return out
    keep = (x != padding_idx)[..., None].to(out.dtype)
    return out * keep + (out * (1 - keep)).detach()


@register_op("one_hot")
def one_hot(x, num_classes, name=None):
    """float32 one-hot rows (an id outside [0, num_classes) gives a row
    of zeros, as ``jax.nn.one_hot``)."""
    cls = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == cls).to(torch.float32)


@register_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    n = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / n


@register_op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = (x1 * x2).sum(axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


@register_op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along axis, epsilon)."""
    norm = torch.pow(torch.pow(x.abs(), p).sum(axis, keepdim=True),
                     1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


@register_op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oc = c // (r * r)
        x = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, oc, h * r, w * r)
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, oc)


@register_op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 2, 4, 5, 1, 3)
    return x.reshape(n, h // r, w // r, c * r * r)


@register_op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w)
        return x.transpose(1, 2).reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    return x.transpose(3, 4).reshape(n, h, w, c)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


@register_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C*kh*kw, L] (C slowest, then the
    kernel rows and columns); paddings [ph, pw] or [top, left, bottom,
    right]."""
    p = _pair(paddings)
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    x = torch.nn.functional.pad(x, (p[1], p[3], p[0], p[2]))
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      dilation=_pair(dilations), padding=0,
                                      stride=_pair(strides))


@register_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of the overlapping patches (``unfold``'s
    transpose)."""
    return torch.nn.functional.fold(
        x, list(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings)[:2],
        stride=_pair(strides))


# -- resize (jax.image.resize) ----------------------------------------------

def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                      out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}
_MODES = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
          "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def _resize_weights(in_size, out_size, scale, translation, kernel,
                    antialias, device, dtype=torch.float64):
    """Weights [in_size, out_size] of one resized dim in `dtype`
    (``jax.image``'s ``compute_weight_mat``)."""
    kw = {"dtype": dtype, "device": device}
    scale = torch.tensor(scale, **kw)
    translation = torch.tensor(translation, **kw)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0) if antialias else 1.0
    sample_f = ((torch.arange(out_size, **kw) + 0.5) * inv_scale -
                translation * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, **kw)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _contract(x, dim, w):
    """x with dim `dim` contracted against weights [in, out]."""
    return torch.movedim(torch.movedim(x, dim, -1) @ w.to(x.dtype), -1, dim)


def _resize_nearest(x, dims, size):
    for d, n in zip(dims, size):
        m = x.shape[d]
        if m == n:
            continue
        offs = torch.floor((torch.arange(n, dtype=torch.float32,
                                         device=x.device) + 0.5) * m / n)
        x = torch.index_select(x, d, offs.to(torch.long))
    return x


@register_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims (see the module docstring): to `size`, or
    to int(dim * scale_factor)."""
    channel_last = not data_format.startswith("NC")
    dims = list(range(1, x.dim() - 1)) if channel_last else \
        list(range(2, x.dim()))
    spatial = [x.shape[d] for d in dims]
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size / scale_factor required")
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * len(spatial)
        size = [int(d * f) for d, f in zip(spatial, sf)]
    size = [int(v) for v in (size.tolist() if hasattr(size, "tolist")
                             else size)]
    jmode = _MODES[mode]
    if jmode == "nearest":
        return _resize_nearest(x, dims, size)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    kernel = _KERNELS[jmode]
    for d, so, si in zip(dims, size, spatial):
        wdt = torch.float64
        if align_corners:
            wdt = torch.float32         # scale_and_translate's float32
            if so == 1 or si == 1:
                scale, trans = float(so) / si, 0.0
            else:
                scale = (so - 1) / (si - 1)
                trans = 0.5 - 0.5 * scale
        elif so == si:
            continue
        else:
            scale, trans = so / si, 0.0
        x = _contract(x, d, _resize_weights(si, so, scale, trans, kernel,
                                            True, x.device, wdt))
    return x


@register_op("upsample")
def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return OP_TABLE["interpolate"]["fn"](x, size, scale_factor, mode,
                                         align_corners, align_mode,
                                         data_format)


@register_op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Sampling grid [N, H, W, 2] (x, y in [-1, 1]) of the affine maps
    theta [N, 2, 3]."""
    n, _, h, w = [int(v) for v in out_shape]
    kw = {"dtype": theta.dtype, "device": theta.device}
    if align_corners:
        ys = torch.linspace(-1, 1, h, **kw)
        xs = torch.linspace(-1, 1, w, **kw)
    else:
        ys = (torch.arange(h, **kw) + 0.5) * 2 / h - 1
        xs = (torch.arange(w, **kw) + 0.5) * 2 / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def _fix_index(index, size, mode):
    if mode == "nearest":
        return index.clamp(0, size - 1)
    if mode == "mirror":
        s = size - 1
        return ((index + s) % (2 * s) - s).abs() if s else \
            torch.zeros_like(index)
    return index


def _map_coordinates(img, coords, order, mode):
    """``jax.scipy.ndimage.map_coordinates`` of img [N, C, H, W] at
    per-image coordinates (iy, ix) [N, Ho, Wo]; cval 0."""
    nodes = []
    for c in coords:
        if order == 0:
            idx = torch.where(c >= 0, torch.floor(c + 0.5),
                              torch.ceil(c - 0.5)).to(torch.long)
            nodes.append([(idx, None)])
        else:
            lower = torch.floor(c)
            up_w = c - lower
            idx = lower.to(torch.long)
            nodes.append([(idx, 1 - up_w), (idx + 1, up_w)])
    n, ch, h, w = img.shape
    flat = img.reshape(n, ch, h * w)
    out = None
    for (iy, wy) in nodes[0]:
        for (ix, wx) in nodes[1]:
            fy, fx = _fix_index(iy, h, mode), _fix_index(ix, w, mode)
            valid = torch.ones_like(iy, dtype=torch.bool)
            if mode == "constant":
                valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            lin = (fy.clamp(0, h - 1) * w + fx.clamp(0, w - 1)).reshape(
                n, 1, -1).expand(n, ch, -1)
            val = torch.gather(flat, 2, lin).reshape(
                (n, ch) + tuple(iy.shape[1:]))
            val = torch.where(valid[:, None], val, torch.zeros_like(val))
            if wy is not None:
                val = (wy * wx)[:, None] * val
            out = val if out is None else out + val
    return out


@register_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x [N, C, H, W] at grid [N, Ho, Wo, 2] (x, y in [-1, 1])."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1) / 2 * (w - 1)
        iy = (gy + 1) / 2 * (h - 1)
    else:
        ix = ((gx + 1) * w - 1) / 2
        iy = ((gy + 1) * h - 1) / 2
    order = 1 if mode == "bilinear" else 0
    jmode = {"zeros": "constant", "border": "nearest",
             "reflection": "mirror"}.get(padding_mode, "constant")
    return _map_coordinates(x, (iy, ix), order, jmode).to(x.dtype)


@register_op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@register_op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """Shift a fold of the channels one segment back and the next fold
    one segment forward (zeros at the ends)."""
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fc = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :fc], torch.zeros_like(xr[:, :1, :fc])], 1)
    right = torch.cat([torch.zeros_like(xr[:, :1, fc:2 * fc]),
                       xr[:, :-1, fc:2 * fc]], 1)
    return torch.cat([left, right, xr[:, :, 2 * fc:]], 2).reshape(
        nt, c, h, w)
