"""Functional surface of the port's serving path: the counterparts of
``paddle_tpu.nn.functional.rms_norm``, ``swiglu`` (the ``swiglu`` op),
``fused_rope`` (the ``fused_rope`` op), ``scaled_dot_product_attention``,
``paged_attention`` and ``ragged_paged_attention``
(``paddle_tpu/nn/functional/attention.py:105-204``), with the same
argument checks. Each routes to its kernel wrapper in ``ops.kernels``:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

from ..ops import kernels as _k

_MASKED = ("scaled_dot_product_attention with {} comes with the training "
           "and flashmask slices of the port; this slice serves unmasked "
           "attention without dropout (the flash kernel)")


def rms_norm(x, weight, epsilon=1e-6):
    """Row RMSNorm over the last dim: float32 compute, the weight multiply
    in float32, one cast to x's type (the Pallas kernel's order)."""
    return _k.rms_norm(x, weight, epsilon)


def swiglu(x, y):
    """silu(x) * y in float32, cast to x's type."""
    return _k.swiglu(x, y)


def fused_rope(x, cos, sin):
    """Rotate-half RoPE. x: [B, S, H, D]; cos/sin: [S, D], cast to x's
    type first."""
    return _k.fused_rope(x, cos, sin)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=False):
    """Layout [B, S, H, D]; key/value may have fewer heads (GQA). With no
    mask and no active dropout this is the flash kernel, causal with
    bottom-right alignment when ``is_causal``. A mask, or dropout while
    training, raises NotImplementedError."""
    if attn_mask is not None:
        raise NotImplementedError(_MASKED.format("attn_mask"))
    if dropout_p > 0.0 and training:
        raise NotImplementedError(_MASKED.format("dropout while training"))
    out, _ = _k.flash_attention_fwd(query, key, value, causal=is_causal)
    return out


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
