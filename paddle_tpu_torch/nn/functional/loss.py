"""Losses: the counterparts of ``paddle_tpu/nn/functional/loss.py``, in
plain PyTorch as the JAX package computes them in XLA. The ops the JAX
package registers with amp=False (the cross-entropies, the binary ones,
nll, kl_div, ctc, focal, hsigmoid and rnnt) are counted and not cast
under ``auto_cast``.

``ctc_loss`` is ``torch.nn.functional.ctc_loss`` per sequence over
log_softmax(log_probs) (the JAX op is ``optax.ctc_loss``, which
normalizes its input the same way); "mean" divides each sequence's loss by
its label length. ``rnnt_loss`` runs the transducer's alpha recursion over
the (T, U) lattice in float32, batched over B.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops.registry import register_op


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


@register_op("cross_entropy", amp=False)
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross-entropy of `input` (logits, or probabilities when use_softmax
    is False) along `axis`, in plain PyTorch as the JAX op computes it in
    XLA (``paddle_tpu/nn/functional/loss.py:22``).

    Soft labels (soft_label, or label of input's shape): target = label,
    smoothed to (1 - e) label + e / C; loss -sum(w_c target log p) per
    sample; "mean" with a class weight w divides by sum(w_c target).
    Hard labels (int, [...] or with a 1 at `axis`): -log p[label], with
    label smoothing (1 - e) nll + e mean(-log p); labels equal to
    ignore_index add 0; a class weight multiplies each sample's loss by
    w[label] and "mean" divides by the sum of those weights, otherwise
    "mean" divides by the count of the labels not ignored (at least 1)."""
    logits = input
    ax = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(logits, dim=ax)
    else:
        logp = torch.log(logits.clamp_min(1e-30))
    if soft_label or tuple(label.shape) == tuple(logits.shape):
        target = label
        if label_smoothing > 0:
            n = logits.shape[ax]
            target = (1 - label_smoothing) * target + label_smoothing / n
        if weight is not None:
            wshape = [1] * logits.dim()
            wshape[ax] = -1
            wb = weight.reshape(wshape)
            loss = -(wb * target * logp).sum(ax)
            if reduction == "mean":
                return loss.sum() / (wb * target).sum(ax).sum().clamp_min(
                    1e-12)
            return _reduce(loss, reduction)
        return _reduce(-(target * logp).sum(ax), reduction)

    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    if tuple(lbl.shape) != tuple(logp.shape[:ax] + logp.shape[ax + 1:]):
        raise ValueError(f"cross_entropy: labels {tuple(label.shape)} do "
                         f"not fit logits {tuple(logits.shape)} at axis "
                         f"{axis}")
    valid = lbl != ignore_index
    idx = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    nll = -logp.gather(ax, idx.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        loss = ((1 - label_smoothing) * nll +
                label_smoothing * -logp.mean(ax))
    else:
        loss = nll
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w = weight[lbl.clamp(0, weight.shape[0] - 1).long()]
        w = torch.where(valid, w, torch.zeros_like(w))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    return _reduce(loss, reduction)




def _softplus_ce(x, label):
    """Sigmoid cross-entropy with logits, max(x, 0) - x label +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-x.abs()))


@register_op("softmax_with_cross_entropy", amp=False)
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """-log softmax(logits) at the label (kept dim at `axis`), or
    -sum(label log softmax) for soft labels; ignored labels add 0."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            li = lbl.long()
        else:
            li = lbl.long().unsqueeze(axis)
        valid = li != ignore_index
        loss = -logp.gather(axis, torch.where(valid, li,
                                              torch.zeros_like(li)))
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@register_op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


@register_op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce((input - label).abs(), reduction)


@register_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


@register_op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean",  # noqa: A002
               name=None):
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)), reduction)


@register_op("binary_cross_entropy", amp=False)
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    x = input.clamp(1e-12, 1 - 1e-12)
    loss = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_op("binary_cross_entropy_with_logits", amp=False)
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            torch.log1p(torch.exp(-logit.abs())) +
            torch.clamp_min(-logit, 0))
    else:
        loss = _softplus_ce(logit, label)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _weighted_mean(loss, valid, weight, li, reduction):
    """The hard-label reductions of cross_entropy and nll_loss: a class
    weight multiplies each sample (mean: by the weights' sum), else mean
    over the labels not ignored."""
    if weight is not None:
        w = weight[li.clamp(0, weight.shape[0] - 1)]
        w = torch.where(valid, w, torch.zeros_like(w))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    return _reduce(loss, reduction)


@register_op("nll_loss", amp=False)
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """-input[label] over the class dim (dim 1 for [N, C, d1, ...])."""
    logp = input
    li = label.long()
    if logp.dim() > 2:
        logp = torch.movedim(logp, 1, -1)
    valid = label != ignore_index
    safe = torch.where(valid, li, torch.zeros_like(li))
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return _weighted_mean(loss, valid, weight, li, reduction)


@register_op("kl_div", amp=False)
def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(label.clamp_min(1e-12)) - input)
        loss = torch.where(label > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@register_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0),
                   reduction)


@register_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0)),
                   reduction)


@register_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1) *
        torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0)), reduction)


@register_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1),
                         1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0), reduction)


@register_op("ctc_loss", amp=False)
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of log_probs [T, B, C] (normalized again by log_softmax)
    against labels [B, L] (see the module docstring). norm_by_times is
    taken and ignored, as in JAX."""
    logp = torch.log_softmax(log_probs, dim=-1)
    loss = TF.ctc_loss(logp, labels.long(), input_lengths.long(),
                       label_lengths.long(), blank=blank, reduction="none")
    if reduction == "mean":
        return (loss / label_lengths.clamp_min(1).to(loss.dtype)).mean()
    return _reduce(loss, reduction)


@register_op("sigmoid_focal_loss", amp=False)
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    p = torch.sigmoid(logit)
    p_t = p * label + (1 - p) * (1 - label)
    loss = _softplus_ce(logit, label) * torch.pow(1 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@register_op("square_error_cost")
def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


@register_op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


@register_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lbl = labels.reshape(-1, 1)
    target = (lbl == lbl.T).to(sim.dtype)
    target = target / target.sum(1, keepdim=True)
    ce = -(target * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = l2_reg * (torch.square(anchor).sum(1).mean() +
                    torch.square(positive).sum(1).mean()) / 4
    return ce + reg


@register_op("hsigmoid_loss", amp=False)
def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree of
    num_classes leaves (leaf = label + num_classes - 1 in an implicit
    heap): the sum of the sigmoid cross-entropies along the path, in
    float32. Custom trees (path_table/path_code) raise, as in JAX."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss custom trees (path_table/path_code) are not "
            "implemented; only the default complete-binary-tree coding")
    b = input.shape[0]
    code_len = int(math.ceil(math.log2(max(num_classes, 2))))
    node = label.reshape(-1).long() + (num_classes - 1)
    xf = input.float()
    losses = torch.zeros(b, dtype=torch.float32, device=input.device)
    for _ in range(code_len):
        parent = torch.div(node - 1, 2, rounding_mode="floor")
        is_right = (node % 2 == 0) & (node > 0)
        valid = node > 0
        w = weight[parent.clamp(0, weight.shape[0] - 1)]
        logit = (xf * w.float()).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[
                parent.clamp(0, bias.numel() - 1)].float()
        bce = _softplus_ce(logit, is_right.float())
        losses = losses + torch.where(valid, bce, torch.zeros_like(bce))
        node = parent
    return losses.reshape(b, 1)


@register_op("rnnt_loss", amp=False)
def rnnt_loss(input, label, input_lengths,  # noqa: A002
              label_lengths, blank=0, fastemit_lambda=0.0, reduction="mean",
              name=None):
    """RNN-Transducer loss of input [B, T, U+1, V] (normalized here by
    log_softmax) against label [B, U]: alpha[t, u] = logaddexp(alpha[t-1,
    u] + blank(t-1, u), alpha[t, u-1] + emit(t, u-1)); the loss is
    -(alpha[T_b - 1, U_b] + blank(T_b - 1, U_b)). FastEmit raises, as in
    JAX."""
    if fastemit_lambda:
        raise NotImplementedError(
            "FastEmit regularization (fastemit_lambda != 0) is not "
            "implemented; pass 0")
    logp = torch.log_softmax(input.float(), dim=-1)
    b, t_len, u1, _ = logp.shape
    u_len = u1 - 1
    lbl = label.long()
    blank_lp = logp[..., blank]                             # B, T, U+1
    emit_lp = logp[:, :, :u_len, :].gather(
        -1, lbl[:, None, :, None].expand(b, t_len, u_len, 1))[..., 0]
    row = [torch.zeros(b, dtype=torch.float32, device=input.device)]
    for u in range(u_len):
        row.append(row[-1] + emit_lp[:, 0, u])
    alphas = [torch.stack(row, 1)]
    for t in range(1, t_len):
        stay = alphas[-1] + blank_lp[:, t - 1, :]
        row = [stay[:, 0]]
        for u in range(u_len):
            row.append(torch.logaddexp(stay[:, u + 1],
                                       row[-1] + emit_lp[:, t, u]))
        alphas.append(torch.stack(row, 1))
    alpha = torch.stack(alphas, 0)                          # T, B, U+1
    tl = input_lengths.long()
    ul = label_lengths.long()
    batch = torch.arange(b, device=input.device)
    nll = -(alpha[tl - 1, batch, ul] + blank_lp[batch, tl - 1, ul])
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll
