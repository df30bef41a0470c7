"""Detection ops: the counterpart of ``paddle_tpu/ops/impl/detection.py``
(``yolo_box``, ``yolo_loss``, ``matrix_nms``, ``bipartite_match``,
``box_clip``, ``psroi_pool``, ``collect_fpn_proposals``,
``distribute_fpn_proposals``, ``yolo_box_head``, ``yolo_box_post``,
``generate_proposals``, ``crf_decoding``, ``dgc``, ``detection_map``).

The dense, differentiable math (the YOLO decode and loss, box_clip,
psroi_pool, dgc) is PyTorch on the input's device. The post-processing
whose output size depends on the data (the NMS family, matching,
proposals, FPN routing, Viterbi decoding, mAP) runs on the host in numpy,
as the JAX package runs it (the reference ships CPU-only kernels for
these); each such op returns its outputs on its input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op
from ._common import device_of_input as _dev
from ._common import from_host as _out
from ._common import to_host as _host


def _center_iou(b1, b2):
    """IoU of (x, y, w, h) center-format boxes (broadcast)."""
    l1, l2 = b1[..., 0] - b1[..., 2] / 2, b2[..., 0] - b2[..., 2] / 2
    r1, r2 = b1[..., 0] + b1[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    t1, t2 = b1[..., 1] - b1[..., 3] / 2, b2[..., 1] - b2[..., 3] / 2
    d1, d2 = b1[..., 1] + b1[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    w = torch.minimum(r1, r2) - torch.maximum(l1, l2)
    h = torch.minimum(d1, d2) - torch.maximum(t1, t2)
    inter = torch.where((w < 0) | (h < 0), torch.zeros_like(w), w * h)
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / torch.clamp_min(union, 1e-10)


def _np_xyxy_iou(a, b, normalized=True):
    """IoU between [N, 4] and [M, 4] corner boxes (the reference's
    JaccardOverlap, +1 pixel when not normalized)."""
    norm = 0.0 if normalized else 1.0

    def area(bx):
        return np.where((bx[:, 2] < bx[:, 0]) | (bx[:, 3] < bx[:, 1]), 0.0,
                        (bx[:, 2] - bx[:, 0] + norm) *
                        (bx[:, 3] - bx[:, 1] + norm))
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(ix2 - ix1 + norm, 0.0) * \
        np.maximum(iy2 - iy1 + norm, 0.0)
    disjoint = (b[None, :, 0] > a[:, None, 2]) | \
        (b[None, :, 2] < a[:, None, 0]) | (b[None, :, 1] > a[:, None, 3]) | \
        (b[None, :, 3] < a[:, None, 1])
    inter = np.where(disjoint, 0.0, inter)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-10)


@register_op("yolo_box")
def yolo_box(x, img_size, anchors=(), class_num=1, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """YOLOv3 box decode. x [N, an_num*(5+class_num) (+an_num), H, W];
    img_size [N, 2] (h, w). Returns (boxes [N, B, 4] xyxy, scores [N, B,
    class_num]), B = an_num*H*W; entries below conf_thresh are zero."""
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    an_num = anchors.shape[0]
    n, _, h, w = x.shape
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    in_h, in_w = downsample_ratio * h, downsample_ratio * w
    if iou_aware:
        iou_pred = torch.sigmoid(x[:, :an_num].reshape(n, an_num, h, w))
        x = x[:, an_num:]
    pred = x.reshape(n, an_num, 5 + class_num, h, w)
    img_hw = img_size.to(torch.float32)
    img_h = img_hw[:, 0][:, None, None, None]
    img_w = img_hw[:, 1][:, None, None, None]
    kw = {"dtype": torch.float32, "device": x.device}
    grid_x = torch.arange(w, **kw)[None, None, None, :]
    grid_y = torch.arange(h, **kw)[None, None, :, None]
    aw = torch.as_tensor(anchors[:, 0], **kw)[None, :, None, None]
    ah = torch.as_tensor(anchors[:, 1], **kw)[None, :, None, None]
    cx = (grid_x + torch.sigmoid(pred[:, :, 0]) * scale + bias) * img_w / w
    cy = (grid_y + torch.sigmoid(pred[:, :, 1]) * scale + bias) * img_h / h
    bw = torch.exp(pred[:, :, 2]) * aw * img_w / in_w
    bh = torch.exp(pred[:, :, 3]) * ah * img_h / in_h
    conf = torch.sigmoid(pred[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * \
            iou_pred ** iou_aware_factor
    keep = conf > conf_thresh
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = x1.clamp_min(0.0)
        y1 = y1.clamp_min(0.0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    scores = conf[:, :, None] * torch.sigmoid(pred[:, :, 5:])
    scores = torch.where(keep[:, :, None], scores, torch.zeros_like(scores))
    boxes = boxes.reshape(n, an_num * h * w, 4)
    scores = torch.movedim(scores, 2, -1).reshape(n, an_num * h * w,
                                                  class_num)
    return boxes, scores


def _sce(x, label):
    """Sigmoid cross-entropy with logits (the reference's
    SigmoidCrossEntropy)."""
    return torch.clamp_min(x, 0.0) - x * label + torch.log1p(
        torch.exp(-x.abs()))


@register_op("yolo_loss")
def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
              anchor_mask=(), class_num=1, ignore_thresh=0.7,
              downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0,
              name=None):
    """YOLOv3 loss. x [N, C, H, W]; gt_box [N, B, 4] (x, y, w, h
    normalized); gt_label [N, B]; gt_score [N, B]. Returns (loss [N],
    objness_mask [N, M, H, W], gt_match_mask [N, B]) with the reference's
    quirks (a square grid in the decode, L1 on tw/th, the location loss
    scaled by (2 - w h) score)."""
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = np.asarray(anchor_mask, np.int64)
    an_num, mask_num = anchors.shape[0], mask.shape[0]
    n, _, h, w = x.shape
    b = gt_box.shape[1]
    input_size = float(downsample_ratio * h)
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    kw = {"dtype": x.dtype, "device": x.device}
    if gt_score is None:
        gt_score = torch.ones((n, b), **kw)
    if use_label_smooth:
        smooth = min(1.0 / class_num, 1.0 / 40.0)
        pos, neg = 1.0 - smooth, smooth
    else:
        pos, neg = 1.0, 0.0
    pred = x.reshape(n, mask_num, 5 + class_num, h, w)
    gt_valid = gt_box[:, :, 2] > 1e-6

    grid_x = torch.arange(w, **kw)[None, None, None, :]
    grid_y = torch.arange(h, **kw)[None, None, :, None]
    aw = torch.as_tensor(anchors[mask, 0], **kw)[None, :, None, None]
    ah = torch.as_tensor(anchors[mask, 1], **kw)[None, :, None, None]
    px = (grid_x + torch.sigmoid(pred[:, :, 0]) * scale + bias) / h
    py = (grid_y + torch.sigmoid(pred[:, :, 1]) * scale + bias) / h
    pw = torch.exp(pred[:, :, 2]) * aw / input_size
    ph = torch.exp(pred[:, :, 3]) * ah / input_size
    pbox = torch.stack([px, py, pw, ph], -1)
    iou = _center_iou(pbox[:, :, :, :, None, :],
                      gt_box[:, None, None, None, :, :])
    iou = torch.where(gt_valid[:, None, None, None, :], iou,
                      torch.zeros_like(iou))
    ignore = iou.amax(-1) > ignore_thresh

    an_shift = torch.stack(
        [torch.zeros(an_num, **kw), torch.zeros(an_num, **kw),
         torch.as_tensor(anchors[:, 0] / input_size, **kw),
         torch.as_tensor(anchors[:, 1] / input_size, **kw)], -1)
    gt_shift = torch.cat([torch.zeros_like(gt_box[:, :, :2]),
                          gt_box[:, :, 2:]], -1)
    an_iou = _center_iou(gt_shift[:, :, None, :], an_shift[None, None])
    best_n = torch.argmax(an_iou, -1)
    mask_lut = np.full((an_num,), -1, np.int64)
    for s, m in enumerate(mask):
        mask_lut[m] = s
    mask_idx = torch.as_tensor(mask_lut, device=x.device)[best_n]
    gt_match_mask = torch.where(gt_valid, mask_idx,
                                torch.full_like(mask_idx, -1)).to(
                                    torch.int32)
    gi = (gt_box[:, :, 0] * w).to(torch.int64).clamp(0, w - 1)
    gj = (gt_box[:, :, 1] * h).to(torch.int64).clamp(0, h - 1)
    matched = gt_valid & (mask_idx >= 0)
    score = gt_score.to(x.dtype)
    bidx = torch.arange(n, device=x.device)[:, None]
    slot = mask_idx.clamp(0, mask_num - 1)
    raw = pred.permute(0, 1, 3, 4, 2)[bidx, slot, gj, gi]     # N, B, 5+cls

    tx = gt_box[:, :, 0] * w - gi.to(x.dtype)
    ty = gt_box[:, :, 1] * h - gj.to(x.dtype)
    a_w = torch.as_tensor(anchors[:, 0], **kw)[best_n]
    a_h = torch.as_tensor(anchors[:, 1], **kw)[best_n]
    safe_wh = torch.clamp_min(gt_box[:, :, 2:4], 1e-9)
    tw = torch.log(safe_wh[:, :, 0] * input_size / a_w)
    th = torch.log(safe_wh[:, :, 1] * input_size / a_h)
    loc_scale = (2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]) * score
    loc = (_sce(raw[:, :, 0], tx) + _sce(raw[:, :, 1], ty) +
           (raw[:, :, 2] - tw).abs() + (raw[:, :, 3] - th).abs())
    zero = torch.zeros_like(loc)
    loc_loss = torch.where(matched, loc * loc_scale, zero).sum(1)

    onehot = (gt_label.long()[..., None] == torch.arange(
        class_num, device=x.device)).to(x.dtype)
    target = onehot * pos + (1.0 - onehot) * neg
    cls_l = _sce(raw[:, :, 5:], target).sum(-1) * score
    cls_loss = torch.where(matched, cls_l, zero).sum(1)

    with torch.no_grad():
        obj = torch.where(ignore, torch.full((), -1.0, **kw),
                          torch.zeros((), **kw))
        cur = obj[bidx, slot, gj, gi]
        obj[bidx, slot, gj, gi] = torch.where(
            matched, torch.where(matched, score, torch.zeros_like(score)),
            cur)
    raw_obj = pred[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _sce(raw_obj, 1.0) * obj,
        torch.where(obj > -0.5, _sce(raw_obj, 0.0),
                    torch.zeros_like(raw_obj))).sum((1, 2, 3))
    return loc_loss + cls_loss + obj_loss, obj, gt_match_mask


def _matrix_nms_single(bboxes, scores, score_threshold, post_threshold,
                       nms_top_k, keep_top_k, use_gaussian, sigma,
                       background_label, normalized):
    """One batch item: bboxes [M, 4], scores [C, M] -> (rows [K, 6],
    idx [K])."""
    all_idx, all_sc, all_cls = [], [], []
    for c in range(scores.shape[0]):
        if c == background_label:
            continue
        sc = scores[c]
        perm = np.nonzero(sc > score_threshold)[0]
        if perm.size == 0:
            continue
        perm = perm[np.argsort(-sc[perm], kind="stable")]
        if nms_top_k > -1 and perm.size > nms_top_k:
            perm = perm[:nms_top_k]
        sel = bboxes[perm]
        iou = np.tril(_np_xyxy_iou(sel, sel, normalized), -1)
        iou_max = np.concatenate([[0.0], np.max(iou[1:, :], axis=1)])
        if use_gaussian:
            decay = np.exp((iou_max[None, :] ** 2 - iou ** 2) * sigma)
        else:
            decay = (1.0 - iou) / (1.0 - iou_max[None, :])
        tri = np.tril(np.ones_like(decay, bool), -1)
        decay = np.where(tri, decay, 1.0)
        ds = np.min(decay, axis=1) * sc[perm]
        keep = ds > post_threshold
        all_idx.append(perm[keep])
        all_sc.append(ds[keep])
        all_cls.append(np.full(int(keep.sum()), c, np.float32))
    if not all_idx:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    idx = np.concatenate(all_idx)
    sc = np.concatenate(all_sc)
    cl = np.concatenate(all_cls)
    order = np.argsort(-sc, kind="stable")
    if keep_top_k > -1 and order.size > keep_top_k:
        order = order[:keep_top_k]
    rows = np.concatenate([cl[order, None], sc[order, None],
                           bboxes[idx[order]]], axis=1)
    return rows.astype(np.float32), idx[order].astype(np.int64)


@register_op("matrix_nms")
def matrix_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
               post_threshold=0.0, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """SOLOv2 Matrix NMS. bboxes [N, M, 4], scores [N, C, M] -> out [K, 6]
    (label, score, xyxy) [, index [K]] [, rois_num [N]]."""
    bb, sc = _host(bboxes), _host(scores)
    n, m = bb.shape[0], bb.shape[1]
    outs, idxs, nums = [], [], []
    for i in range(n):
        rows, idx = _matrix_nms_single(
            bb[i], sc[i], float(score_threshold), float(post_threshold),
            int(nms_top_k), int(keep_top_k), bool(use_gaussian),
            float(gaussian_sigma), int(background_label), bool(normalized))
        outs.append(rows)
        idxs.append(idx + i * m)
        nums.append(rows.shape[0])
    dev = _dev(bboxes)
    res = [_out(np.concatenate(outs) if outs else
                np.zeros((0, 6), np.float32), dev)]
    if return_index:
        res.append(_out(np.concatenate(idxs) if idxs else
                        np.zeros((0,), np.int64), dev))
    if return_rois_num:
        res.append(_out(np.asarray(nums, np.int32), dev))
    return tuple(res) if len(res) > 1 else res[0]


@register_op("bipartite_match")
def bipartite_match(dist_mat, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    """Greedy max-weight bipartite matching of dist_mat [R, C] (rows =
    priors, columns = ground truth) -> (col_to_row [C] int64, col_dist
    [C] float32); "per_prediction" also matches unmatched columns to
    their best free row at or above dist_threshold."""
    d = np.array(_host(dist_mat), np.float64, copy=True)
    r, c = d.shape
    match_idx = np.full((c,), -1, np.int64)
    match_dist = np.zeros((c,), np.float32)
    work = d.copy()
    for _ in range(min(r, c)):
        i, j = divmod(int(np.argmax(work)), c)
        if work[i, j] <= 0:
            break
        match_idx[j] = i
        match_dist[j] = d[i, j]
        work[i, :] = -1.0
        work[:, j] = -1.0
    if match_type == "per_prediction":
        row_taken = set(int(x) for x in match_idx if x >= 0)
        for j in range(c):
            if match_idx[j] >= 0:
                continue
            col = d[:, j].copy()
            for i in row_taken:
                col[i] = -1.0
            i = int(np.argmax(col))
            if col[i] >= dist_threshold:
                match_idx[j] = i
                match_dist[j] = d[i, j]
    dev = _dev(dist_mat)
    return _out(match_idx, dev), _out(match_dist, dev)


@register_op("box_clip")
def box_clip(input, im_info, name=None):  # noqa: A002
    """Clip xyxy boxes [N, B, 4] (or [B, 4]) to [0, dim / scale - 1] of
    im_info [N, 3] (h, w, scale)."""
    x = input
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    h = (im_info[:, 0] / im_info[:, 2] - 1.0)[:, None]
    w = (im_info[:, 1] / im_info[:, 2] - 1.0)[:, None]
    out = torch.stack([torch.minimum(x[..., 0].clamp_min(0.0), w),
                       torch.minimum(x[..., 1].clamp_min(0.0), h),
                       torch.minimum(x[..., 2].clamp_min(0.0), w),
                       torch.minimum(x[..., 3].clamp_min(0.0), h)], -1)
    return out[0] if squeeze else out


@register_op("psroi_pool")
def psroi_pool(x, boxes, boxes_num, pooled_height=1, pooled_width=1,
               output_channels=1, spatial_scale=1.0, name=None):
    """Position-sensitive RoI average pool (R-FCN). x [N, oc*ph*pw, H,
    W]; boxes [R, 4] xyxy; boxes_num [N] -> [R, oc, ph, pw]; bin (o, i,
    j) averages channel group (o, i, j) over its rounded bin (0 when the
    bin is empty)."""
    n, _, hh, ww = x.shape
    ph, pw, oc = int(pooled_height), int(pooled_width), int(output_channels)
    batch_idx = torch.repeat_interleave(
        torch.arange(n, device=x.device), boxes_num.long().to(x.device),
        output_size=boxes.shape[0])
    roi = boxes.to(torch.float32) * spatial_scale
    x0 = torch.round(roi[:, 0])
    y0 = torch.round(roi[:, 1])
    x1 = torch.round(roi[:, 2]) + 1.0
    y1 = torch.round(roi[:, 3]) + 1.0
    bin_w = torch.clamp_min(x1 - x0, 0.1) / pw
    bin_h = torch.clamp_min(y1 - y0, 0.1) / ph
    feat = x.reshape(n, oc, ph, pw, hh, ww)[batch_idx].float()
    yy = torch.arange(hh, dtype=torch.float32, device=x.device)
    xx = torch.arange(ww, dtype=torch.float32, device=x.device)
    out = torch.zeros((boxes.shape[0], oc, ph, pw), dtype=torch.float32,
                      device=x.device)
    for py in range(ph):
        for px in range(pw):
            hs = torch.floor(y0 + py * bin_h).clamp(0, hh)
            he = torch.ceil(y0 + (py + 1) * bin_h).clamp(0, hh)
            ws = torch.floor(x0 + px * bin_w).clamp(0, ww)
            we = torch.ceil(x0 + (px + 1) * bin_w).clamp(0, ww)
            m = ((yy[None, :, None] >= hs[:, None, None]) &
                 (yy[None, :, None] < he[:, None, None]) &
                 (xx[None, None, :] >= ws[:, None, None]) &
                 (xx[None, None, :] < we[:, None, None])).float()
            cnt = torch.clamp_min(m.sum((1, 2)), 1.0)
            val = (feat[:, :, py, px] * m[:, None]).sum((-2, -1)) / \
                cnt[:, None]
            empty = (he <= hs) | (we <= ws)
            out[:, :, py, px] = torch.where(empty[:, None],
                                            torch.zeros_like(val), val)
    return out.to(x.dtype)


@register_op("collect_fpn_proposals")
def collect_fpn_proposals(multi_level_rois, multi_level_scores,
                          multi_level_rois_num=None, post_nms_top_n=-1,
                          name=None):
    """Concatenate the levels' RoIs and keep the top post_nms_top_n by
    score per image (one image without multi_level_rois_num). Returns
    (fpn_rois, rois_num)."""
    rois_l = [_host(r) for r in multi_level_rois]
    scores_l = [_host(s).reshape(-1) for s in multi_level_scores]
    if multi_level_rois_num is None:
        splits = [np.asarray([r.shape[0]], np.int64) for r in rois_l]
        n_img = 1
    else:
        splits = [_host(c).reshape(-1).astype(np.int64)
                  for c in multi_level_rois_num]
        n_img = len(splits[0])
    outs, nums = [], []
    for i in range(n_img):
        rois_i, scores_i = [], []
        for r, s, cnt in zip(rois_l, scores_l, splits):
            off = int(cnt[:i].sum())
            rois_i.append(r[off:off + int(cnt[i])])
            scores_i.append(s[off:off + int(cnt[i])])
        r = np.concatenate(rois_i, axis=0)
        s = np.concatenate(scores_i, axis=0)
        order = np.argsort(-s, kind="stable")
        if post_nms_top_n > -1:
            order = order[:post_nms_top_n]
        outs.append(r[order])
        nums.append(order.size)
    dev = _dev(multi_level_rois[0])
    return (_out(np.concatenate(outs) if outs else
                 np.zeros((0, 4), np.float32), dev),
            _out(np.asarray(nums, np.int32), dev))


@register_op("distribute_fpn_proposals", wrap=False)
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Route each RoI to level floor(log2(sqrt(area) / refer_scale)) +
    refer_level, clipped to [min_level, max_level]. Returns (multi_rois
    list, restore_index int32 [, multi_rois_num list]); each level's rows
    are grouped image by image."""
    rois = _host(fpn_rois)
    dev = _dev(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 0.0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    if rois_num is not None:
        counts = _host(rois_num).reshape(-1)
        img_of = np.repeat(np.arange(len(counts)), counts)
        n_img = len(counts)
    else:
        img_of = np.zeros(rois.shape[0], np.int64)
        n_img = 1
    multi, nums, parts = [], [], []
    for li in range(max_level - min_level + 1):
        in_lvl = lvl == min_level + li
        sel_parts = [np.nonzero(in_lvl & (img_of == im))[0]
                     for im in range(n_img)]
        sel = np.concatenate(sel_parts)
        multi.append(_out(rois[sel], dev))
        nums.append(_out(np.asarray([s.size for s in sel_parts], np.int32),
                         dev))
        parts.append(sel)
    order = np.concatenate(parts)
    restore = np.empty_like(order)
    restore[order] = np.arange(order.size)
    restore = _out(restore.astype(np.int32), dev)
    if rois_num is not None:
        return multi, restore, nums
    return multi, restore


@register_op("yolo_box_head")
def yolo_box_head(x, anchors=(), class_num=1, name=None):
    """The elementwise decode head: sigmoid on x/y/obj/class channels,
    exp on w/h."""
    n, c, h, w = x.shape
    an_num = max(1, len(anchors) // 2)
    p = x.reshape(n, an_num, 5 + class_num, h, w)
    return torch.cat([torch.sigmoid(p[:, :, 0:2]), torch.exp(p[:, :, 2:4]),
                      torch.sigmoid(p[:, :, 4:])], 2).reshape(n, c, h, w)


@register_op("yolo_box_post")
def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale,
                  anchors0=(), anchors1=(), anchors2=(), class_num=1,
                  conf_thresh=0.01, downsample_ratio0=32,
                  downsample_ratio1=16, downsample_ratio2=8, clip_bbox=True,
                  scale_x_y=1.0, nms_threshold=0.45, name=None):
    """Decode three FPN levels with yolo_box, merge, then greedy NMS per
    class. Returns (out [K, 6] (label, score, xyxy), nms_rois_num [N])."""
    img = (image_shape / torch.clamp_min(image_scale, 1e-8)
           if image_scale is not None else image_shape)
    img = img.to(torch.int32)
    levels = [(boxes0, anchors0, downsample_ratio0),
              (boxes1, anchors1, downsample_ratio1),
              (boxes2, anchors2, downsample_ratio2)]
    all_b, all_s = [], []
    for feat, anc, ds in levels:
        b, s = yolo_box(feat, img, anchors=anc, class_num=class_num,
                        conf_thresh=conf_thresh, downsample_ratio=ds,
                        clip_bbox=clip_bbox, scale_x_y=scale_x_y)
        all_b.append(b)
        all_s.append(s)
    boxes = _host(torch.cat(all_b, 1))
    scores = _host(torch.cat(all_s, 1))
    outs, nums = [], []
    for i in range(boxes.shape[0]):
        rows = []
        for c in range(class_num):
            sc = scores[i, :, c]
            keep = np.nonzero(sc > conf_thresh)[0]
            keep = keep[np.argsort(-sc[keep], kind="stable")]
            sel = []
            for j in keep:
                if not sel or _np_xyxy_iou(
                        boxes[i, j:j + 1],
                        boxes[i, np.asarray(sel)]).max() <= nms_threshold:
                    sel.append(j)
            for j in sel:
                rows.append([c, sc[j], *boxes[i, j]])
        outs.append(np.asarray(rows, np.float32).reshape(-1, 6))
        nums.append(len(rows))
    dev = _dev(boxes0)
    return (_out(np.concatenate(outs) if outs else
                 np.zeros((0, 6), np.float32), dev),
            _out(np.asarray(nums, np.int32), dev))


@register_op("generate_proposals")
def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=True, name=None):
    """RPN proposals. scores [N, A, H, W]; bbox_deltas [N, 4A, H, W];
    anchors/variances [H, W, A, 4]. Returns (rpn_rois [K, 4],
    rpn_roi_probs [K, 1], rpn_rois_num [N])."""
    sc, bd, ims = _host(scores), _host(bbox_deltas), _host(im_shape)
    anc = _host(anchors).reshape(-1, 4)
    var = _host(variances).reshape(-1, 4)
    n, a, h, w = sc.shape
    off = 1.0 if pixel_offset else 0.0
    rois_all, probs_all, nums = [], [], []
    for i in range(n):
        s_i = sc[i].transpose(1, 2, 0).reshape(-1)
        d_i = bd[i].reshape(a, 4, h, w).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s_i, kind="stable")
        if pre_nms_top_n > 0:
            order = order[:pre_nms_top_n]
        aw = anc[order, 2] - anc[order, 0] + off
        ah = anc[order, 3] - anc[order, 1] + off
        ax = anc[order, 0] + aw / 2
        ay = anc[order, 1] + ah / 2
        v, d = var[order], d_i[order]
        cx = v[:, 0] * d[:, 0] * aw + ax
        cy = v[:, 1] * d[:, 1] * ah + ay
        bw = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000.0 / 16))) * aw
        bh = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000.0 / 16))) * ah
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - off,
                          cy + bh / 2 - off], axis=1)
        hh, ww = ims[i, 0], ims[i, 1]
        boxes[:, 0] = np.clip(boxes[:, 0], 0, ww - off)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, hh - off)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, ww - off)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, hh - off)
        keep_size = ((boxes[:, 2] - boxes[:, 0] + off >= min_size) &
                     (boxes[:, 3] - boxes[:, 1] + off >= min_size))
        boxes = boxes[keep_size]
        probs = s_i[order][keep_size]
        sel = []
        for j in range(boxes.shape[0]):
            if len(sel) >= post_nms_top_n > 0:
                break
            if not sel or _np_xyxy_iou(
                    boxes[j:j + 1], boxes[np.asarray(sel)],
                    normalized=not pixel_offset).max() <= nms_thresh:
                sel.append(j)
        rois_all.append(boxes[sel])
        probs_all.append(probs[sel, None])
        nums.append(len(sel))
    dev = _dev(scores)
    rois = np.concatenate(rois_all) if rois_all else \
        np.zeros((0, 4), np.float32)
    probs = np.concatenate(probs_all) if probs_all else \
        np.zeros((0, 1), np.float32)
    return (_out(rois.astype(np.float32), dev),
            _out(probs.astype(np.float32), dev),
            _out(np.asarray(nums, np.int32), dev))


@register_op("crf_decoding")
def crf_decoding(emission, transition, label=None, length=None, lod=None,
                 name=None):
    """Viterbi decode of a linear-chain CRF; transition rows [start,
    stop, W]. Packed form (emission [total_T, T] + lod offsets) or padded
    batch (emission [B, L, T] + length [B]). With label: the 0/1
    correctness of each position."""
    em, tr = _host(emission), _host(transition)
    a, b_stop, w = tr[0], tr[1], tr[2:]

    def viterbi(x):
        t, tag = x.shape
        alpha = np.zeros((t, tag))
        track = np.zeros((t, tag), np.int64)
        alpha[0] = a + x[0]
        for k in range(1, t):
            score = alpha[k - 1][:, None] + w
            track[k] = np.argmax(score, axis=0)
            alpha[k] = np.max(score, axis=0) + x[k]
        path = np.zeros((t,), np.int64)
        path[-1] = int(np.argmax(alpha[-1] + b_stop))
        for k in range(t - 1, 0, -1):
            path[k - 1] = track[k, path[k]]
        return path

    if em.ndim == 3:
        lens = _host(length).reshape(-1)
        out = np.zeros(em.shape[:2], np.int64)
        for i in range(em.shape[0]):
            li = int(lens[i])
            if li:
                out[i, :li] = viterbi(em[i, :li])
    else:
        offs = [0, em.shape[0]] if lod is None else _host(lod).reshape(-1)
        out = np.zeros((em.shape[0], 1), np.int64)
        for i in range(len(offs) - 1):
            s, e = int(offs[i]), int(offs[i + 1])
            if e > s:
                out[s:e, 0] = viterbi(em[s:e])
    if label is not None:
        out = (out == _host(label).reshape(out.shape)).astype(np.int64)
    return _out(out, _dev(emission))


@register_op("dgc")
def dgc(u, v, grad, param=None, current_step=None, nranks=None, m=0.9,
        use_nesterov=True, sparsity=(), rampup_begin_step=0.0,
        rampup_step=0.0, regular_coeff=0.0, regular_type=0, name=None):
    """Deep Gradient Compression: momentum correction and top-k magnitude
    sparsification. Returns (u_out, v_out, encode_grad, grad_out, k,
    gather_buff)."""
    g = grad
    if regular_coeff and param is not None:
        if regular_type == 1:
            g = g + regular_coeff * param
        elif regular_type == 2:
            g = g + regular_coeff * param * param.abs()
    step = float(_host(current_step).reshape(-1)[0]) \
        if current_step is not None else 0.0
    ratio = 0.999
    if sparsity:
        if rampup_step > 0:
            idx = min(int(max(step - rampup_begin_step, 0) / rampup_step *
                          len(sparsity)), len(sparsity) - 1)
        else:
            idx = len(sparsity) - 1
        ratio = float(sparsity[idx])
    numel = g.numel()
    k = max(1, int(numel * (1.0 - ratio)))
    u_out = m * u + g
    v_out = v + u_out
    thr = torch.sort(v_out.reshape(-1).abs())[0][numel - k]
    mask = v_out.abs() >= thr
    zero = torch.zeros_like(v_out)
    encode_grad = torch.where(mask, v_out, zero)
    grad_out = torch.where(mask, zero, v_out)
    if use_nesterov:
        u_out = torch.where(mask, torch.zeros_like(u_out), u_out)
    return (u_out, torch.where(mask, zero, v_out), encode_grad, grad_out,
            torch.tensor(float(k), dtype=torch.float32, device=g.device),
            torch.zeros_like(encode_grad))


@register_op("detection_map")
def detection_map(detect_res, label, has_state=None, pos_count=None,
                  true_pos=None, false_pos=None, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_type="integral",
                  class_num=None, background_label=0, name=None):
    """mAP of detections [D, 6] (label, score, xyxy) against ground truth
    [L, 6] (label, xyxy, difficult) or [L, 5]; a float32 scalar."""
    det, gt = _host(detect_res), _host(label)
    if gt.shape[1] == 5:
        gt = np.concatenate([gt, np.zeros((gt.shape[0], 1))], axis=1)
    classes = sorted(set(int(c) for c in gt[:, 0]) |
                     set(int(c) for c in det[:, 0]))
    aps = []
    for c in classes:
        if c == background_label:
            continue
        gtc = gt[gt[:, 0] == c]
        if not evaluate_difficult:
            gtc = gtc[gtc[:, 5] == 0]
        dc = det[det[:, 0] == c]
        dc = dc[np.argsort(-dc[:, 1], kind="stable")]
        npos = gtc.shape[0]
        if npos == 0 and dc.shape[0] == 0:
            continue
        taken = np.zeros(gtc.shape[0], bool)
        tp = np.zeros(dc.shape[0])
        fp = np.zeros(dc.shape[0])
        for i in range(dc.shape[0]):
            if gtc.shape[0] == 0:
                fp[i] = 1
                continue
            iou = _np_xyxy_iou(dc[i:i + 1, 2:6], gtc[:, 1:5])[0]
            j = int(np.argmax(iou))
            if iou[j] >= overlap_threshold and not taken[j]:
                tp[i] = 1
                taken[j] = True
            else:
                fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        rec = ctp / max(npos, 1)
        prec = ctp / np.maximum(ctp + cfp, 1e-10)
        if ap_type == "11point":
            ap = float(np.mean([np.max(prec[rec >= t], initial=0.0)
                                for t in np.linspace(0, 1, 11)]))
        else:
            ap, prev_r = 0.0, 0.0
            for r, p in zip(rec, prec):
                ap += (r - prev_r) * p
                prev_r = r
        aps.append(ap)
    return _out(np.asarray(np.mean(aps) if aps else 0.0, np.float32),
                _dev(detect_res))
