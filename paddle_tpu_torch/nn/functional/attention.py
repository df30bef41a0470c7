"""Attention functionals: the counterparts of
``paddle_tpu/nn/functional/attention.py`` — ``scaled_dot_product_attention``,
``flash_attention``, ``flashmask_attention``, ``paged_attention``,
``ragged_paged_attention``, ``softmax_mask_fuse`` and
``softmax_mask_fuse_upper_triangle``. Layout [B, S, H, D].

The kernel paths (the flash forward and backward, flashmask, the paged
decode and ragged kernels) run the port's CUDA kernels on CUDA tensors
and their plain versions on CPU tensors. Every entry point hands the
kernels dense tensors (``_dense``): a strided view (q, k and v sliced out
of one packed projection, as the UNet's attention block makes them)
takes the same path as a contiguous tensor on both devices. Attention
with a dense mask or with dropout while training is plain PyTorch
(``_sdpa_dense``) on both devices, as the JAX package computes it in XLA
(``_sdpa_xla``) outside any kernel.
"""

from __future__ import annotations

import math

import torch

from ...framework.random import default_generator
from ...ops import kernels as _k
from ...ops.kernels.decode_attention import NEG_INF
from ...ops.registry import register_op


def _dense(*tensors):
    """Each tensor contiguous (a copy only of a strided view): the kernels
    index raw pointers with packed strides, so every entry point hands
    them dense tensors."""
    return tuple(t.contiguous() for t in tensors)


def _sdpa_dense(q, k, v, mask=None, dropout_p=0.0, causal=False,
                training=True, return_lse=False, generator=None, scale=None):
    """``_sdpa_xla``: attention with the [B, H, S, T] logits materialized.
    q/k/v [B, S, H, D] (K/V heads repeated under GQA); mask bool (True =
    attend) or additive, broadcast against the logits; logits in float32,
    probabilities in q's type, dropout on the probabilities while
    training. return_lse adds the float32 logsumexp of the masked logits
    [B, H, S] (of -1e30 logits on a row that sees nothing). scale
    defaults to 1/sqrt(D) (the graph compiler passes a matched one)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
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


@register_op("scaled_dot_product_attention")
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
        return _k.FlashAttention.apply(*_dense(query, key, value),
                                       is_causal, None)
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


@register_op("flashmask_attention")
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
                *_dense(query, key, value, ms, me),
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


@register_op("paged_attention")
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
    query, k_pages, v_pages, block_tables, context_lens = _dense(
        query, k_pages, v_pages, block_tables, context_lens)
    if k_scales is not None:
        out = _k.paged_decode_attention_int8(query, k_pages, v_pages,
                                             k_scales, v_scales, block_tables,
                                             context_lens, scale=scale)
    else:
        out = _k.paged_decode_attention(query, k_pages, v_pages,
                                        block_tables, context_lens,
                                        scale=scale)
    return out[:, None] if squeeze else out


@register_op("ragged_paged_attention")
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
    query, k_pages, v_pages, block_tables, context_lens, q_lens = _dense(
        query, k_pages, v_pages, block_tables, context_lens, q_lens)
    if k_scales is not None:
        return _k.ragged_paged_attention_int8(query, k_pages, v_pages,
                                              k_scales, v_scales,
                                              block_tables, context_lens,
                                              q_lens, scale=scale)
    return _k.ragged_paged_attention(query, k_pages, v_pages, block_tables,
                                     context_lens, q_lens, scale=scale)




@register_op("flash_attention")
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, *,
                    generator=None):
    """(out, None): the flash kernel without active dropout (causal with
    bottom-right alignment), else the dense plain path with dropout on
    the probabilities. fixed_seed_offset and rng_name are taken and
    ignored, as in the JAX op."""
    if dropout == 0.0 or not training:
        out = _k.FlashAttention.apply(*_dense(query, key, value), causal,
                                      None)
    else:
        out = _sdpa_dense(query, key, value, None, dropout, causal,
                          training=training, generator=generator)
    return out, None


@register_op("softmax_mask_fuse")
def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last dim in float32, cast to x's
    type."""
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


@register_op("softmax_mask_fuse_upper_triangle")
def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal-masked softmax over the last two dims (bottom-right
    aligned), in float32, cast to x's type."""
    s_q, s_k = x.shape[-2], x.shape[-1]
    cm = torch.ones(s_q, s_k, dtype=torch.bool,
                    device=x.device).tril(s_k - s_q)
    logits = torch.where(cm, x.float(), torch.full_like(x, NEG_INF,
                                                         dtype=torch.float32))
    return torch.softmax(logits, dim=-1).to(x.dtype)
