"""Functional surface of the port's serving and training paths: the
counterparts of ``paddle_tpu.nn.functional.rms_norm``, ``swiglu`` (the
``swiglu`` op), ``fused_rope`` (the ``fused_rope`` op),
``scaled_dot_product_attention``, ``paged_attention`` and
``ragged_paged_attention`` (``paddle_tpu/nn/functional/attention.py:
105-204``), ``cross_entropy`` (``nn/functional/loss.py:22``, hard labels)
and the ``fused_linear_cross_entropy`` op (``ops/impl/fused.py:271-396``),
with the same argument checks. Each routes to its kernel wrapper in
``ops.kernels`` (the CUDA kernel for CUDA tensors, the plain version for
CPU tensors), the differentiable ones through the kernel's autograd
function.
"""

from __future__ import annotations

import torch

from ..ops import kernels as _k

_MASK = ("scaled_dot_product_attention with an attn_mask comes with the "
         "flashmask slice of the port; the flash kernel attends unmasked "
         "(causal or full)")
_DROPOUT = ("scaled_dot_product_attention with dropout while training comes "
            "with a later slice of the port; the flash kernel has no dropout")


def rms_norm(x, weight, epsilon=1e-6):
    """Row RMSNorm over the last dim: float32 compute, the weight multiply
    in float32, one cast to x's type (the Pallas kernel's order)."""
    return _k.RMSNorm.apply(x, weight, epsilon)


def swiglu(x, y):
    """silu(x) * y in float32, cast to x's type."""
    return _k.SwiGLU.apply(x, y)


def fused_rope(x, cos, sin):
    """Rotate-half RoPE. x: [B, S, H, D]; cos/sin: [S, D], cast to x's
    type first. The tables get no gradient."""
    return _k.FusedRoPE.apply(x, cos, sin)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=False):
    """Layout [B, S, H, D]; key/value may have fewer heads (GQA). With no
    mask and no active dropout this is the flash kernel, causal with
    bottom-right alignment when ``is_causal``, and its backward is the
    flash backward kernel. A mask, or dropout while training, raises
    NotImplementedError."""
    if attn_mask is not None:
        raise NotImplementedError(_MASK)
    if dropout_p > 0.0 and training:
        raise NotImplementedError(_DROPOUT)
    return _k.FlashAttention.apply(query, key, value, is_causal, None)


def paged_attention(query, k_pages, v_pages, block_tables, context_lens,
                    scale=None, k_scales=None, v_scales=None):
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
                           v_scales=None):
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


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):  # noqa: A002
    """Softmax cross-entropy of logits `input` [..., C] against hard int
    labels [...] (or [..., 1]), in plain PyTorch: the counterpart of
    ``paddle_tpu.nn.functional.cross_entropy`` for hard labels. Labels
    equal to ignore_index add 0; "mean" divides by the count of the others
    (at least 1). Soft labels, class weights and label smoothing come with
    a later slice of the port."""
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    if label.shape != input.shape[:-1]:
        raise ValueError(f"cross_entropy: labels {tuple(label.shape)} do "
                         f"not fit logits {tuple(input.shape)} (hard labels "
                         "only; soft labels come with a later slice)")
    valid = label != ignore_index
    logp = torch.log_softmax(input, dim=-1)
    idx = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -logp.gather(-1, idx[..., None])[..., 0]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")


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
