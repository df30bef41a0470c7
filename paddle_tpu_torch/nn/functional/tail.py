"""``nn.functional``'s tail: the counterpart of
``paddle_tpu/nn/functional/tail.py`` — the small losses
(``gaussian_nll_loss``, ``poisson_nll_loss``, ``soft_margin_loss``,
``multi_label_soft_margin_loss``, ``multi_margin_loss``,
``triplet_margin_with_distance_loss``, ``dice_loss``,
``adaptive_log_softmax_with_loss``, ``margin_cross_entropy``),
``pairwise_distance``, ``class_center_sample``, ``feature_alpha_dropout``
(registered as ops under the JAX names), and the plain functions
``zeropad2d``, ``lp_pool1d``, ``max_unpool1d``, the packed flash entry
points and ``sparse_attention``, which ``install`` (:301) adds to the
namespace with the in-place activations (``relu_``, ``tanh_``, ...) and
the ``gather_tree`` / ``sequence_mask`` aliases.

``flash_attn_qkvpacked`` (:233) and ``flash_attn_varlen_qkvpacked``
(:245) go through ``attention.flash_attention``: on CUDA tensors the
flash kernel's op (forward, and its backward under autograd), once per
call, and once per sequence for the varlen form, as the JAX function
loops over the sequences.

``sparse_attention`` (:269) computes what the JAX function delegates to
its ``sparse`` package: softmax(q k^T / sqrt(d)) restricted to the CSR
pattern, a row with no stored logit giving 0; as the JAX function does,
it takes ``key_padding_mask`` and ``attn_mask`` and does not apply them.

The random ops draw from the port's generator of their input's device
(``generator=`` overrides it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...framework.random import default_generator
from ...ops.registry import OP_TABLE as _T
from ...ops.registry import make_inplace, register_op
from .loss import _reduce


@register_op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,  # noqa: A002
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    out = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        out = out + 0.5 * math.log(2 * math.pi)
    return _reduce(out, reduction)


@register_op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    if log_input:
        out = torch.exp(input) - label * input
    else:
        out = input - label * torch.log(input + epsilon)
    if full:
        safe = label + (label == 0).to(label.dtype)
        stirling = label * torch.log(safe) - label + \
            0.5 * torch.log(2 * math.pi * safe)
        out = out + torch.where(label > 1, stirling,
                                torch.zeros_like(stirling))
    return _reduce(out, reduction)


@register_op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce(torch.log1p(torch.exp(-label.to(input.dtype) * input)),
                   reduction)


@register_op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    out = -(label * TF.logsigmoid(input) + (1 - label) * TF.logsigmoid(-input))
    if weight is not None:
        out = out * weight
    return _reduce(out.mean(dim=-1), reduction)


@register_op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    n, c = input.shape
    lab = label.to(torch.int64).reshape(-1)
    correct = torch.gather(input, 1, lab[:, None])
    diff = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        diff = diff * weight[lab][:, None]
    mask = TF.one_hot(lab, c).to(input.dtype)
    return _reduce((diff * (1 - mask)).sum(dim=1) / c, reduction)


@register_op("triplet_margin_with_distance_loss", amp=False)
def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (
        lambda a, b: torch.linalg.vector_norm(a - b, dim=-1))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


@register_op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    lab = TF.one_hot(label.to(torch.int64).squeeze(-1),
                     input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * lab).sum(dim=dims)
    union = input.sum(dim=dims) + lab.sum(dim=dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


@register_op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


@register_op("adaptive_log_softmax_with_loss")
def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,  # noqa: A002
                                   cutoffs, head_bias=None, name=None):
    """(per-row log-probability of its label, -mean): the head softmax
    over the frequent classes and one entry per cluster, each cluster a
    projected tail softmax."""
    lab = label.to(torch.int64).reshape(-1)
    head_logits = input @ head_weight
    if head_bias is not None:
        head_logits = head_logits + head_bias
    head_lp = torch.log_softmax(head_logits, dim=-1)
    n_head = head_weight.shape[1] - len(cutoffs)
    out = torch.zeros(lab.shape, dtype=input.dtype, device=input.device)
    in_head = lab < cutoffs[0] if cutoffs else torch.ones_like(lab,
                                                               dtype=bool)
    safe = lab.clamp(0, head_lp.shape[1] - 1)
    out = torch.where(in_head, torch.gather(head_lp, 1, safe[:, None])[:, 0],
                      out)
    lo = cutoffs[0] if cutoffs else 0
    for i, (w_proj, w_out) in enumerate(tail_weights):
        hi = cutoffs[i + 1] if i + 1 < len(cutoffs) else lo + w_out.shape[1]
        in_c = (lab >= lo) & (lab < hi)
        tail_lp = torch.log_softmax((input @ w_proj) @ w_out, dim=-1)
        rel = (lab - lo).clamp(0, w_out.shape[1] - 1)
        out = torch.where(in_c, head_lp[:, n_head + i] + torch.gather(
            tail_lp, 1, rel[:, None])[:, 0], out)
        lo = hi
    return out, -out.mean()


@register_op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace/CosFace-margined softmax cross entropy over cosine
    logits."""
    lab = label.to(torch.int64).reshape(-1)
    theta = torch.arccos(logits.clamp(-1.0, 1.0))
    marg = torch.cos(margin1 * theta + margin2) - margin3
    onehot = TF.one_hot(lab, logits.shape[-1]).to(logits.dtype)
    logp = torch.log_softmax(torch.where(onehot > 0, marg, logits) * scale,
                             dim=-1)
    loss = _reduce(-torch.gather(logp, 1, lab[:, None])[:, 0], reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


@register_op("class_center_sample")
def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None, *, generator=None):
    """(labels remapped onto the sampled classes, the sorted sampled
    classes): every class present in `label`, plus classes drawn without
    replacement up to num_samples. The draw is numpy's from a seed the
    port's generator draws, on the host, as the JAX op draws."""
    import numpy as np
    gen = generator if generator is not None else \
        default_generator(label.device)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                             device=gen.device))
    lab = label.detach().cpu().numpy().astype(np.int64).reshape(-1)
    pos = np.unique(lab)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    extra = np.random.default_rng(seed).choice(
        rest, size=max(0, min(num_samples, num_classes) - len(pos)),
        replace=False) if len(rest) else np.empty(0, np.int64)
    sampled = np.sort(np.concatenate([pos, extra]))
    new_lab = np.searchsorted(sampled, lab)
    return (torch.from_numpy(new_lab.astype(np.int64)).to(label.device),
            torch.from_numpy(sampled.astype(np.int64)).to(label.device))


@register_op("feature_alpha_dropout")
def feature_alpha_dropout(x, p=0.5, training=True, name=None, *,
                          generator=None):
    """Alpha dropout of whole channel maps (dim 1)."""
    if not training or p == 0.0:
        return x
    alpha = -1.7580993408473766
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    gen = generator if generator is not None else default_generator(x.device)
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - p
    a = torch.tensor(1 / math.sqrt((alpha ** 2 * p + 1) * (1 - p)),
                     dtype=x.dtype, device=x.device)
    b = -a * alpha * p
    return a * torch.where(keep, x, torch.full_like(x, alpha)) + b


# ---- the plain functions (not ops in JAX either) ---------------------------

def zeropad2d(x, padding, data_format="NCHW", name=None):
    return _T["pad"]["api"](x, padding, mode="constant", value=0.0,
                            data_format=data_format)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """``lp_pool2d`` over [N, C, L, 1]."""
    out = _T["lp_pool2d"]["api"](x.unsqueeze(-1), norm_type,
                                 (kernel_size, 1),
                                 stride=(stride or kernel_size, 1),
                                 padding=(padding, 0), ceil_mode=ceil_mode)
    return out.squeeze(-1)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """``max_unpool2d`` over [N, C, L, 1]."""
    out = _T["max_unpool2d"]["api"](
        x.unsqueeze(-1), indices.unsqueeze(-1), (kernel_size, 1),
        stride=(stride or kernel_size, 1), padding=(padding, 0),
        output_size=None if output_size is None
        else list(output_size) + [1])
    return out.squeeze(-1)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """qkv [B, S, 3, H, D] -> ``flash_attention(q, k, v)``: (out, None)."""
    from .attention import flash_attention
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """qkv [total, 3, H, D] packed by the offsets cu_seqlens_q: one
    ``flash_attention`` per sequence, the outputs packed again [total, H,
    D]. scale is taken and ignored, as in JAX (the kernels scale by
    1/sqrt(D))."""
    from .attention import flash_attention
    cq = [int(v) for v in (cu_seqlens_q.tolist()
                           if isinstance(cu_seqlens_q, torch.Tensor)
                           else cu_seqlens_q)]
    outs = []
    for b in range(len(cq) - 1):
        seg = qkv[cq[b]:cq[b + 1]]
        o, _ = flash_attention(seg[None, :, 0], seg[None, :, 1],
                               seg[None, :, 2], dropout=dropout,
                               causal=causal, training=training)
        outs.append(o[0])
    return torch.cat(outs, dim=0)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over [B, H, S, D] restricted to a CSR pattern per (b, h)
    (offsets [B, H, S + 1], columns [B, H, nnz]): see the module
    docstring."""
    b, h, s, d = query.shape
    off = sparse_csr_offset.reshape(b * h, s + 1).to(torch.int64)
    cols = sparse_csr_columns.reshape(b * h, -1).to(torch.int64)
    pattern = torch.zeros(b * h, s, s, dtype=torch.bool,
                          device=query.device)
    for i in range(b * h):
        nnz = int(off[i, -1])
        rows = torch.repeat_interleave(
            torch.arange(s, device=query.device), off[i, 1:] - off[i, :-1])
        pattern[i, rows, cols[i, :nnz]] = True
    pattern = pattern.reshape(b, h, s, s)
    scores = torch.einsum("bhsd,bhtd->bhst", query, key) / math.sqrt(d)
    scores = torch.where(pattern, scores, torch.full_like(
        scores, torch.finfo(scores.dtype).min))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(pattern.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhst,bhtd->bhsd", p, value)


_INPLACE_ACTS = ["relu", "tanh", "softmax", "elu", "hardtanh",
                 "leaky_relu", "thresholded_relu"]


def install(ns):
    """Add to `ns` (``nn.functional``'s namespace) the in-place
    activations, the plain functions above and the ``gather_tree`` /
    ``sequence_mask`` ops, as the JAX ``install`` does."""
    for base in _INPLACE_ACTS:
        nm = base + "_"
        if nm not in ns and base in ns:
            ns[nm] = make_inplace(base, ns[base])
    for nm in ("zeropad2d", "lp_pool1d", "max_unpool1d",
               "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
               "sparse_attention"):
        ns.setdefault(nm, globals()[nm])
    for op in ("gather_tree", "sequence_mask"):
        if op in _T:
            ns.setdefault(op, _T[op]["api"])
