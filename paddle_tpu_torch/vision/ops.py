"""``paddle.vision.ops``: the counterpart of ``paddle_tpu/vision/ops.py`` —
``nms`` (:36), ``roi_align`` (:68), ``roi_pool`` (:121), ``box_coder``
(:151), ``prior_box`` (:196) and ``deform_conv2d`` (:246, the op at
:258), registered as ops under the JAX names.

The JAX ops are ``jnp`` code (no Pallas kernel); the port's are torch
code on the input's device. ``nms`` computes the IoU matrix on the
device and runs its sequential suppression loop on the host in numpy
(the JAX op's ``fori_loop`` keeps it on the device, and then reads the
kept count back to size its output); the kept indices go back to the
boxes' device. ``roi_align`` and ``roi_pool`` sample every box's bins at
once with gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.registry import OP_TABLE, register_op


def _iou_matrix(boxes):
    """[N, 4] xyxy -> [N, N] IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-10)


@register_op("nms")
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Kept box indices (int64), by descending score (in index order
    without scores): a box is dropped when its IoU with a kept box before
    it exceeds iou_threshold; with category_idxs only boxes of one
    category suppress each other."""
    n = boxes.shape[0]
    order = torch.arange(n, device=boxes.device) if scores is None else \
        torch.argsort(-scores, stable=True)
    sorted_boxes = boxes[order]
    if category_idxs is not None:
        offs = category_idxs[order].to(boxes.dtype) * (
            boxes.max() - boxes.min() + 1.0)
        sorted_boxes = sorted_boxes + offs[:, None]
    over = (_iou_matrix(sorted_boxes) > iou_threshold).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(1, n):
        keep[i] = not np.any(keep[:i] & over[i, :i])
    kept = order[torch.from_numpy(np.nonzero(keep)[0]).to(boxes.device)]
    return kept[:top_k] if top_k is not None else kept


def _image_of(boxes_num, n, r, device):
    counts = torch.as_tensor(boxes_num, device=device).to(torch.int64)
    return torch.repeat_interleave(torch.arange(n, device=device), counts,
                                   output_size=r)


@register_op("roi_align")
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """x [N, C, H, W]; boxes [R, 4] xyxy in input coordinates; boxes_num
    [N] boxes per image. Each of the [oh, ow] bins averages sr x sr
    bilinear samples (sr = sampling_ratio, 2 when not positive), in
    float32: [R, C, oh, ow] in x's dtype."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    R = boxes.shape[0]
    img_of = _image_of(boxes_num, N, R, x.device)
    off = 0.5 if aligned else 0.0
    bx = boxes.to(torch.float32) * spatial_scale - off
    w1, h1, w2, h2 = bx.unbind(-1)
    rw = torch.clamp(w2 - w1, min=1e-6 if aligned else 1.0)
    rh = torch.clamp(h2 - h1, min=1e-6 if aligned else 1.0)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    f32 = {"dtype": torch.float32, "device": x.device}
    gy = (torch.arange(oh * sr, **f32) + 0.5) / sr
    gx = (torch.arange(ow * sr, **f32) + 0.5) / sr
    ys = h1[:, None] + gy[None, :] * (rh / oh)[:, None]      # [R, P]
    xs = w1[:, None] + gx[None, :] * (rw / ow)[:, None]      # [R, Q]
    y0 = ys.floor().clamp(0, H - 1).to(torch.int64)
    x0 = xs.floor().clamp(0, W - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy = (ys.clamp(0, H - 1) - y0)[:, None, :, None]          # [R,1,P,1]
    wx = (xs.clamp(0, W - 1) - x0)[:, None, None, :]          # [R,1,1,Q]
    imgs = x.to(torch.float32)
    r = img_of[:, None, None]

    def at(yi, xi):                       # [R, C, P, Q]
        return imgs[r, :, yi[:, :, None], xi[:, None, :]].permute(
            0, 3, 1, 2)

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx +
           at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return out.reshape(R, C, oh, sr, ow, sr).mean((3, 5)).to(x.dtype)


@register_op("roi_pool")
def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """The max of each bin over a 4 x 4 grid of samples of the rounded
    box (the JAX op's static-shape form): [R, C, oh, ow]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    N, C, H, W = x.shape
    R = boxes.shape[0]
    img_of = _image_of(boxes_num, N, R, x.device)
    bx = torch.round(boxes.to(torch.float32) * spatial_scale)
    w1, h1, w2, h2 = bx.unbind(-1)
    rw = torch.clamp(w2 - w1 + 1, min=1.0)
    rh = torch.clamp(h2 - h1 + 1, min=1.0)
    sr = 4
    f32 = {"dtype": torch.float32, "device": x.device}
    gy = h1[:, None] + (torch.arange(oh * sr, **f32) + 0.5)[None] * \
        (rh / (oh * sr))[:, None]
    gx = w1[:, None] + (torch.arange(ow * sr, **f32) + 0.5)[None] * \
        (rw / (ow * sr))[:, None]
    yi = gy.clamp(0, H - 1).to(torch.int64)
    xi = gx.clamp(0, W - 1).to(torch.int64)
    patch = x[img_of[:, None, None], :, yi[:, :, None],
              xi[:, None, :]].permute(0, 3, 1, 2)
    return patch.reshape(R, C, oh, sr, ow, sr).amax((3, 5))


@register_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode target boxes [T, 4] against priors [P, 4] into [T, P, 4]
    offsets (divided by the variances when given: [4] shared or [P, 4]),
    or decode offsets [T, P, 4] (or [P, 4]) into boxes; float32."""
    pb = prior_box.to(torch.float32)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if prior_box_var is None:
        var = torch.ones((1, 4), dtype=torch.float32, device=pb.device)
    else:
        var = torch.as_tensor(prior_box_var, dtype=torch.float32,
                              device=pb.device)
        if var.dim() == 1:
            var = var.reshape(1, 4)
    tb = target_box.to(torch.float32)
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10))
        oh = torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        return out / var[None] if prior_box_var is not None else out
    if tb.dim() == 2:
        tb = tb[:, None, :]
    vx, vy, vw, vh = (var[None, :, i] for i in range(4))
    dx = tb[..., 0] * vx * pw + pcx
    dy = tb[..., 1] * vy * ph + pcy
    dw = torch.exp(tb[..., 2] * vw) * pw
    dh = torch.exp(tb[..., 3] * vh) * ph
    return torch.stack([dx - dw * 0.5, dy - dh * 0.5,
                        dx + dw * 0.5 - norm, dy + dh * 0.5 - norm], dim=-1)


@register_op("prior_box")
def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD anchors over input's [H, W] grid for an image's size: (boxes,
    variances), each [H, W, n_priors, 4] float32, boxes normalized by the
    image size."""
    H, W = input.shape[-2], input.shape[-1]
    img_h, img_w = image.shape[-2], image.shape[-1]
    step_h = steps[1] or img_h / H
    step_w = steps[0] or img_w / W
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    whs = []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * ar ** 0.5, ms / ar ** 0.5))
        else:
            for ar in ars:
                whs.append((ms * ar ** 0.5, ms / ar ** 0.5))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
    f32 = {"dtype": torch.float32, "device": input.device}
    whs = torch.tensor(whs, **f32)                   # [P, 2]
    cx = (torch.arange(W, **f32) + offset) * step_w
    cy = (torch.arange(H, **f32) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")    # [H, W]
    boxes = torch.stack([
        (cxg[..., None] - whs[:, 0] / 2) / img_w,
        (cyg[..., None] - whs[:, 1] / 2) / img_h,
        (cxg[..., None] + whs[:, 0] / 2) / img_w,
        (cyg[..., None] + whs[:, 1] / 2) / img_h,
    ], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.tensor(variance, **f32).expand(boxes.shape)
    return boxes, var


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution (v1; v2 with a modulation mask): the
    ``deform_conv2d`` op."""
    return OP_TABLE["deform_conv2d"]["api"](x, offset, weight, bias, stride,
                                            padding, dilation,
                                            deformable_groups, groups, mask)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register_op("deform_conv2d")
def _deform_conv2d_impl(x, offset, weight, bias=None, stride=1, padding=0,
                        dilation=1, deformable_groups=1, groups=1,
                        mask=None, name=None):
    """Each output position samples its kh x kw taps at the base grid
    plus the offsets [N, 2 dg kh kw, oh, ow] ((y, x) per tap), bilinear
    over the zero-padded input (a tap outside it reads 0), times the mask
    when given; then the grouped product with the weight, in float32."""
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    N, C, H, W = x.shape
    Co, Cg, kh, kw = weight.shape
    oh = (H + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (W + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    xf = torch.nn.functional.pad(x.to(torch.float32),
                                 (padding[1], padding[1], padding[0],
                                  padding[0]))
    Hp, Wp = xf.shape[2], xf.shape[3]
    f32 = {"dtype": torch.float32, "device": x.device}
    base_y = ((torch.arange(oh, **f32) * stride[0])[:, None, None, None] +
              (torch.arange(kh, **f32) * dilation[0])[None, None, :, None]
              ).expand(oh, ow, kh, kw)
    base_x = ((torch.arange(ow, **f32) * stride[1])[None, :, None, None] +
              (torch.arange(kw, **f32) * dilation[1])[None, None, None, :]
              ).expand(oh, ow, kh, kw)
    dg = deformable_groups
    offs = offset.to(torch.float32).reshape(N, dg, kh * kw, 2, oh, ow)
    # [N, oh, ow, dg, kh, kw]
    off_y = offs[:, :, :, 0].reshape(N, dg, kh, kw, oh, ow).permute(
        0, 4, 5, 1, 2, 3)
    off_x = offs[:, :, :, 1].reshape(N, dg, kh, kw, oh, ow).permute(
        0, 4, 5, 1, 2, 3)
    if mask is not None:
        m = mask.to(torch.float32).reshape(N, dg, kh, kw, oh, ow).permute(
            0, 4, 5, 1, 2, 3)
    else:
        m = torch.ones((N, oh, ow, dg, kh, kw), **f32)
    cpg = C // dg

    def sample(ch, yy, xx, mm):          # ch [cpg, Hp, Wp] -> [cpg, ...]
        y0 = yy.floor().clamp(0, Hp - 1).to(torch.int64)
        x0 = xx.floor().clamp(0, Wp - 1).to(torch.int64)
        y1 = (y0 + 1).clamp(max=Hp - 1)
        x1 = (x0 + 1).clamp(max=Wp - 1)
        wy = yy.clamp(0, Hp - 1) - y0
        wx = xx.clamp(0, Wp - 1) - x0
        val = (ch[:, y0, x0] * (1 - wy) * (1 - wx) +
               ch[:, y0, x1] * (1 - wy) * wx +
               ch[:, y1, x0] * wy * (1 - wx) + ch[:, y1, x1] * wy * wx)
        inb = (yy > -1) & (yy < Hp) & (xx > -1) & (xx < Wp)
        return val * inb * mm

    cols = []
    for n in range(N):
        cols.append(torch.cat([
            sample(xf[n, g * cpg:(g + 1) * cpg], base_y + off_y[n, :, :, g],
                   base_x + off_x[n, :, :, g], m[n, :, :, g])
            for g in range(dg)], dim=0))         # [C, oh, ow, kh, kw]
    col = torch.stack(cols)
    wg = weight.to(torch.float32)
    if groups == 1:
        out = torch.einsum("nchwyx,ocyx->nohw", col, wg)
    else:
        cg_in = C // groups
        out = torch.einsum(
            "ngchwyx,gocyx->ngohw",
            col.reshape(N, groups, cg_in, oh, ow, kh, kw),
            wg.reshape(groups, Co // groups, cg_in, kh, kw)).reshape(
                N, Co, oh, ow)
    if bias is not None:
        out = out + torch.as_tensor(bias, **f32).reshape(1, -1, 1, 1)
    return out.to(x.dtype)
