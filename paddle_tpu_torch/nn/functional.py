"""Functional surface of the port's serving and training paths: the
counterparts of ``paddle_tpu.nn.functional.rms_norm``, ``swiglu`` (the
``swiglu`` op), ``fused_rope`` (the ``fused_rope`` op; ``fused_rope_qk``
rotates q and k in one launch), ``linear``,
``dropout`` (``nn/functional/common.py:18, :28``), ``layer_norm``
(``nn/functional/norm.py:54``), ``scaled_dot_product_attention``,
``flashmask_attention``, ``paged_attention`` and ``ragged_paged_attention``
(``paddle_tpu/nn/functional/attention.py``), ``cross_entropy``
(``nn/functional/loss.py:22``) and the
``fused_linear_cross_entropy`` op (``ops/impl/fused.py:271-396``), with the
same argument checks. Each function takes the JAX function's parameters in
its order, with its names and defaults (``name`` is taken and ignored, as
paddle's is); torch-only extras (``generator=``) are keyword-only after
them. The kernel ops route to their wrappers in
``ops.kernels`` (the CUDA kernel for CUDA tensors, the plain version for
CPU tensors), the differentiable ones through the kernel's autograd
function. Attention with a dense mask or with dropout while training is
plain PyTorch (``_sdpa_dense``) on both devices, as the JAX package
computes it in XLA (``_sdpa_xla``) outside any kernel. Functionals that
draw random numbers take ``generator=`` (default: the device's generator
in ``framework.random``).
"""

from __future__ import annotations

import math

import torch

from ..framework.random import default_generator
from ..ops import kernels as _k
from ..ops.kernels.decode_attention import NEG_INF


def linear(x, weight, bias=None, name=None):
    """y = x @ weight (+ bias); weight [in, out] (paddle's layout)."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


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
    gen = generator if generator is not None else default_generator(x.device)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    else:
        shape = x.shape
    keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing `normalized_shape` dims, in float32 for
    bf16/f16 inputs; the normalized value is cast to x's type BEFORE the
    weight multiply and the bias add (the fused bdrln op multiplies in
    float32 and casts last)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dims, keepdim=True)
    var = xf.var(dims, unbiased=False, keepdim=True)
    out = ((xf - mean) * torch.reciprocal(torch.sqrt(var + epsilon))).to(
        x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over the dims from `begin_norm_axis` on, through the RMSNorm
    kernel (the trailing dims flattened into one row; weight, of their
    shape, flattened alike; no weight multiplies by ones): float32 compute,
    the weight multiply in float32, one cast to x's type (the Pallas
    kernel's order). bias, of the same shape, is added after the cast in
    plain PyTorch, as the JAX op adds it in XLA."""
    axis = begin_norm_axis % x.dim()
    n = math.prod(x.shape[axis:])
    w = (torch.ones(n, dtype=x.dtype, device=x.device) if weight is None
         else weight.reshape(n))
    out = _k.RMSNorm.apply(x.reshape(*x.shape[:axis], n), w,
                           epsilon).reshape(x.shape)
    return out if bias is None else out + bias


def swiglu(x, y=None, name=None):
    """silu(x) * y in float32, cast to x's type; with y None, x's last dim
    splits in two halves (x, y), as the JAX op splits it."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return _k.SwiGLU.apply(x.contiguous(), y.contiguous())


def fused_rope(x, cos, sin):
    """Rotate-half RoPE. x: [B, S, H, D]; cos/sin: [S, D], cast to x's
    type first. The tables get no gradient."""
    return _k.FusedRoPE.apply(x, cos, sin)


def fused_rope_qk(q, k, cos, sin):
    """Rotate-half RoPE of q [B, S, Hq, D] and k [B, S, Hk, D] (Hk
    dividing Hq) by the same tables, in one kernel launch each way: the
    port's own, where the JAX model rotates q and k apart. cos/sin: [S, D]
    or the rows at each token's own position ([B, S, D], or [B, D] when
    S = 1; these take no gradient). Returns (q_rot, k_rot)."""
    return _k.FusedRoPEQK.apply(q, k, cos, sin)


def _sdpa_dense(q, k, v, mask=None, dropout_p=0.0, causal=False,
                training=True, return_lse=False, generator=None):
    """``_sdpa_xla``: attention with the [B, H, S, T] logits materialized.
    q/k/v [B, S, H, D] (K/V heads repeated under GQA); mask bool (True =
    attend) or additive, broadcast against the logits; logits in float32,
    probabilities in q's type, dropout on the probabilities while
    training. return_lse adds the float32 logsumexp of the masked logits
    [B, H, S] (of -1e30 logits on a row that sees nothing)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) * scale).float()
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        gen = generator if generator is not None else \
            default_generator(q.device)
        keep = torch.rand(probs.shape, generator=gen, device=q.device) < \
            1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    out = torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
    """Layout [B, S, H, D]; key/value may have fewer heads (GQA). With no
    mask and no active dropout this is the flash kernel, causal with
    bottom-right alignment when ``is_causal``, and its backward is the
    flash backward kernel. With a mask (bool, True = attend, or additive)
    or dropout while training it is the dense plain path."""
    if attn_mask is None and (dropout_p == 0.0 or not training):
        return _k.FlashAttention.apply(query, key, value, is_causal, None)
    return _sdpa_dense(query, key, value, attn_mask, dropout_p, is_causal,
                       training=training, generator=generator)


def _flashmask_intervals(idx, causal, s):
    """startend_row_indices [B, kh, T, {1, 2, 4}] -> up to two masked row
    intervals per key column, (start, end, start2, end2), each [B, kh, T]
    int32 (start2/end2 None when one suffices):

      causal,  1 bound : masked [start, S)
      causal,  2 bounds: masked [start, end)
      ~causal, 2 bounds: masked [LT_start, S) and [0, UT_end)
      ~causal, 4 bounds: masked [LT_start, LT_end) and [UT_start, UT_end)
    """
    nb = idx.shape[-1]
    if causal:
        if nb == 1:
            ms = idx[..., 0]
            return ms, torch.full_like(ms, s), None, None
        if nb == 2:
            return idx[..., 0], idx[..., 1], None, None
        raise ValueError(f"causal flashmask expects 1 or 2 bounds, got {nb}")
    if nb == 2:
        ms = idx[..., 0]
        return ms, torch.full_like(ms, s), torch.zeros_like(ms), idx[..., 1]
    if nb == 4:
        return idx[..., 0], idx[..., 1], idx[..., 2], idx[..., 3]
    raise ValueError(
        f"bidirectional flashmask expects 2 or 4 bounds, got {nb}")


def _window_to_indices(window_size, b, s, t, causal, device):
    """Sliding-window attention as startend_row_indices: one bound per key
    column (T of them), rows clipped to the query length S. The causal
    diagonal is bottom-right aligned (query row i sits at position
    i + T - S), so the band around key j covers positions [j - w1, j + w0],
    minus the (T - S) offset in query-row coordinates."""
    if isinstance(window_size, int):
        window_size = (window_size, window_size)
    w0, w1 = window_size
    off = t - s
    col = torch.arange(t, dtype=torch.int32, device=device)
    if causal:
        idx = (col + w0 + 1 - off).clamp(0, s)[None, None, :, None]
    else:
        lo = (col + w0 + 1 - off).clamp(0, s)
        hi = (col - w1 - off).clamp(0, s)
        idx = torch.stack([lo, hi], dim=-1)[None, None]
    return idx.expand((b,) + tuple(idx.shape[1:])).to(torch.int32)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, *, generator=None):
    """Attention with a sparse row-range mask. query [B, S, H, D], key/value
    [B, T, H_kv, D]; startend_row_indices [B, kh, T, {1, 2, 4}] int (kh 1,
    H_kv or H; see ``_flashmask_intervals``) or window_size (an int or
    (left, right)), not both. With bounds and no active dropout this is the
    flashmask kernel (forward and, through autograd, backward), which never
    builds the dense mask; with dropout while training the same intervals
    become a dense mask for the plain path. Without bounds it is the dense
    plain path (causal or not). Rows that see no key output 0. Returns out,
    or a list [out, lse] / [out, seed_offset] / [out, lse, seed_offset]:
    lse [B, H, S] float32, detached (see ``ops.kernels.flash_attention``
    for its value on rows that see no key); seed_offset int64 zeros [2].
    fixed_seed_offset and rng_name are taken and ignored, as in the JAX
    op: dropout draws from `generator`, and there is no seed counter."""
    b, s, h, _ = query.shape
    t, h_kv = key.shape[1], key.shape[2]
    if window_size is not None:
        if startend_row_indices is not None:
            raise ValueError(
                "window_size and startend_row_indices are exclusive")
        startend_row_indices = _window_to_indices(window_size, b, s, t,
                                                  causal, query.device)
    lse = None
    if startend_row_indices is not None:
        ms, me, ms2, me2 = _flashmask_intervals(
            startend_row_indices.to(torch.int32), causal, s)
        kh = ms.shape[1]
        if kh not in (1, h, h_kv):
            raise ValueError(f"flashmask head dim {kh} must be 1, num_heads "
                             f"{h}, or k_num_heads {h_kv}")
        if dropout == 0.0 or not training:
            out, lse = _k.FlashmaskAttention.apply(
                query, key, value, ms.contiguous(), me.contiguous(),
                None if ms2 is None else ms2.contiguous(),
                None if me2 is None else me2.contiguous(), causal, None)
        else:
            rows = torch.arange(s, device=query.device)[None, None, :, None]
            masked = (ms[:, :, None, :] <= rows) & (rows < me[:, :, None, :])
            if ms2 is not None:
                masked = masked | ((ms2[:, :, None, :] <= rows) &
                                   (rows < me2[:, :, None, :]))
            mask = ~masked                                   # B, kh, S, T
            if causal:
                cm = torch.ones(s, t, dtype=torch.bool,
                                device=query.device).tril(t - s)
                mask = mask & cm
            if kh == h_kv and h_kv != h:
                mask = mask.repeat_interleave(h // h_kv, dim=1)
            out, lse = _sdpa_dense(query, key, value, mask, dropout, False,
                                   training=training, return_lse=True,
                                   generator=generator)
            out = out * mask.any(-1).transpose(1, 2)[..., None]
    elif return_softmax_lse:
        out, lse = _sdpa_dense(query, key, value, None, dropout, causal,
                               training=training, return_lse=True,
                               generator=generator)
    else:
        out = _sdpa_dense(query, key, value, None, dropout, causal,
                          training=training, generator=generator)
    outputs = [out]
    if return_softmax_lse:
        outputs.append(lse.float().detach())
    if return_seed_offset:
        outputs.append(torch.zeros(2, dtype=torch.int64,
                                   device=query.device))
    return outputs[0] if len(outputs) == 1 else outputs


def paged_attention(query, k_pages, v_pages, block_tables, context_lens,
                    scale=None, k_scales=None, v_scales=None, name=None):
    """Decode-phase attention over a block-paged KV cache.

    query: [B, H, D] (one token per sequence) or [B, 1, H, D];
    k_pages/v_pages: [N_pages, page, H_kv, D]; block_tables: [B, P_max]
    int32 (entries past context_lens are ignored); context_lens: [B] int32
    visible tokens per sequence INCLUDING the current one. k_scales/
    v_scales ([N_pages] float32, the layer's per-page scale rows) select
    the dequant-fused kernel over int8 pools. Returns the output with
    query's rank."""
    squeeze = query.dim() == 4
    if squeeze:
        if query.shape[1] != 1:
            raise ValueError(
                f"paged_attention decodes ONE token per sequence; got "
                f"query seq dim {query.shape[1]}")
        query = query[:, 0]
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is not None:
        out = _k.paged_decode_attention_int8(query, k_pages, v_pages,
                                             k_scales, v_scales, block_tables,
                                             context_lens, scale=scale)
    else:
        out = _k.paged_decode_attention(query, k_pages, v_pages,
                                        block_tables, context_lens,
                                        scale=scale)
    return out[:, None] if squeeze else out


def ragged_paged_attention(query, k_pages, v_pages, block_tables,
                           context_lens, q_lens, scale=None, k_scales=None,
                           v_scales=None, name=None):
    """Mixed prefill+decode attention over a block-paged KV cache in one
    launch. query: [C, Q_max, H, D] right-padded rows; row r's q_lens[r]
    real queries sit at the TAIL of its context; context_lens [C] counts
    the queries themselves (their KV is in the pages already); q_lens [C].
    k_scales/v_scales select the int8 kernel (see paged_attention).
    Returns [C, Q_max, H, D] with padded query rows zeroed."""
    if query.dim() != 4:
        raise ValueError(
            f"ragged_paged_attention expects query [C, Q_max, H, D]; got "
            f"rank {query.dim()}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is not None:
        return _k.ragged_paged_attention_int8(query, k_pages, v_pages,
                                              k_scales, v_scales,
                                              block_tables, context_lens,
                                              q_lens, scale=scale)
    return _k.ragged_paged_attention(query, k_pages, v_pages, block_tables,
                                     context_lens, q_lens, scale=scale)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")


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


def _flce_logits(hid, weight, off, chunk, v, transpose_w):
    """float32 logits [T, chunk] of vocab columns [off, off + chunk), the
    columns past V at -inf (``_flce_fwd_impl``'s padded chunk)."""
    end = min(off + chunk, v)
    wc = (weight[off:end] if transpose_w else weight[:, off:end]).float()
    logits = hid @ (wc.t() if transpose_w else wc)
    if end - off < chunk:
        logits = torch.nn.functional.pad(logits, (0, chunk - (end - off)),
                                         value=float("-inf"))
    return logits, wc


class FusedLinearCrossEntropy(torch.autograd.Function):
    """``_fused_linear_ce`` of ``ops/impl/fused.py``: mean cross-entropy of
    hidden [T, H] @ weight [H, V] ([V, H] with transpose_w) against labels
    [T], streaming the vocab in chunks through an online logsumexp so the
    [T, V] logits never exist; the backward recomputes each chunk's logits
    and folds (softmax - onehot) into the dhidden and dweight products.
    The chunk products are float32 ``torch.matmul`` (the JAX package
    leaves them to XLA: no TPU kernel)."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, transpose_w, chunk):
        t = hidden.shape[0]
        v = weight.shape[0] if transpose_w else weight.shape[1]
        n_chunks = -(-v // chunk)
        hid = hidden.float()
        lab = labels.long()
        valid = lab >= 0
        m = torch.full((t,), float("-inf"), device=hidden.device)
        s = torch.zeros(t, device=hidden.device)
        zl = torch.zeros(t, device=hidden.device)
        for ci in range(n_chunks):
            off = ci * chunk
            logits, _ = _flce_logits(hid, weight, off, chunk, v, transpose_w)
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            in_c = (lab >= off) & (lab < off + chunk)
            picked = logits.gather(
                1, (lab - off).clamp(0, chunk - 1)[:, None])[:, 0]
            zl = zl + torch.where(in_c, picked, torch.zeros_like(picked))
            m = m_new
        lse = m + torch.log(s)
        n_valid = valid.sum().clamp_min(1).float()
        loss = torch.where(valid, lse - zl, torch.zeros_like(lse)).sum() / \
            n_valid
        ctx.save_for_backward(hidden, weight, lab, lse)
        ctx.transpose_w, ctx.chunk = transpose_w, chunk
        return loss.to(hidden.dtype)

    @staticmethod
    def backward(ctx, g):
        hidden, weight, lab, lse = ctx.saved_tensors
        transpose_w, chunk = ctx.transpose_w, ctx.chunk
        v = weight.shape[0] if transpose_w else weight.shape[1]
        n_chunks = -(-v // chunk)
        hid = hidden.float()
        valid = lab >= 0
        n_valid = valid.sum().clamp_min(1).float()
        # d(mean over valid rows): ignored rows get no pull at all
        gt = (g.float() / n_valid) * valid.float()
        dhid = torch.zeros_like(hid)
        dw = torch.empty_like(weight)
        rows = torch.arange(hid.shape[0], device=hid.device)
        for ci in range(n_chunks):
            off = ci * chunk
            n = min(chunk, v - off)
            logits, wc = _flce_logits(hid, weight, off, chunk, v,
                                      transpose_w)
            d = torch.exp(logits[:, :n] - lse[:, None])
            in_c = valid & (lab >= off) & (lab < off + n)
            d[rows[in_c], lab[in_c] - off] -= 1.0      # softmax - onehot
            d = d * gt[:, None]
            if transpose_w:
                dw[off:off + n] = (d.t() @ hid).to(weight.dtype)
                dhid = dhid + d @ wc
            else:
                dw[:, off:off + n] = (hid.t() @ d).to(weight.dtype)
                dhid = dhid + d @ wc.t()
        return dhid.to(hidden.dtype), dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels,
                               transpose_weight=False, chunk_size=4096):
    """Mean softmax cross-entropy of ``hidden @ weight`` against int labels
    without materializing the [T, V] logits. hidden [..., H] is flattened
    to [T, H] and labels to [T]; weight [H, V] ([V, H] with
    transpose_weight, the tied-embedding layout). Labels below 0 add 0 and
    the mean is over the others; the loss has hidden's type. The chunk is
    min(chunk_size, V rounded up to 128), as in the JAX op."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l2 = labels.reshape(-1)
    v = weight.shape[0] if transpose_weight else weight.shape[-1]
    chunk = min(int(chunk_size), max(128, -(-int(v) // 128) * 128))
    return FusedLinearCrossEntropy.apply(h2, weight, l2,
                                         bool(transpose_weight), chunk)
