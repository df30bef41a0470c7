"""The fused op surface: the counterpart of ``paddle_tpu/ops/impl/fused.py``.

Each name is a thin call into what the port already has, so the kernels
it reaches are the port's CUDA kernels on the card (their plain versions
on the CPU), as the JAX names reach their Pallas kernels on the TPU:

- ``fused_rms_norm``: ``nn.functional.rms_norm`` (the RMSNorm kernel);
- ``fused_rope``: ``nn.functional.fused_rope`` and
  ``fused_rotary_position_embedding``: ``incubate.nn.functional``'s, q
  and k in one launch (the RoPE kernel);
- ``fused_bias_dropout_residual_layer_norm`` and ``fused_feedforward``:
  ``incubate.nn.functional`` (the bias + dropout + residual + LayerNorm
  kernel; ``fused_feedforward``'s post-norm tail, and its swiglu through
  the SwiGLU kernel);
- ``fused_linear_cross_entropy``: ``nn.functional``'s chunked loss;
- ``fused_linear``, ``fused_bias_act``, ``fused_linear_param_grad_add``,
  ``block_multihead_attention`` (the paged decode kernel) and
  ``masked_multihead_attention``: ``incubate.nn.functional``'s.

The modules are imported at the call, so importing the op surface loads
no kernel module.
"""

from __future__ import annotations

from ...device import resolve_device
from ..registry import register_op


def _F():
    from ...nn import functional
    return functional


def _IF():
    from ...incubate.nn import functional
    return functional


@register_op("fused_rope")
def fused_rope(x, cos, sin, name=None):
    """Rotate-half RoPE. x: [B, S, H, D]; cos/sin: [S, D]."""
    return _F().fused_rope(x.contiguous(), cos.contiguous(),
                           sin.contiguous())


@register_op("fused_rms_norm")
def fused_rms_norm(x, weight, epsilon=1e-6, name=None):
    return _F().rms_norm(x, weight, epsilon=epsilon)


@register_op("fused_rotary_position_embedding")
def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """RoPE of q (and k) by [S, D] or [1, S, 1, D] tables; v passes
    through. Returns (q, k, v)."""
    return _IF().fused_rotary_position_embedding(
        q, k, v, sin=sin, cos=cos, position_ids=position_ids,
        use_neox_rotary_style=use_neox_rotary_style)


@register_op("fused_linear")
def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return _IF().fused_linear(x, weight, bias, transpose_weight)


@register_op("fused_bias_act")
def fused_bias_act(x, bias=None, act_method="gelu", name=None, **kw):
    return _IF().fused_bias_act(x, bias, act_method)


@register_op("fused_linear_param_grad_add")
def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True,
                                name=None):
    return _IF().fused_linear_param_grad_add(x, dout, dweight, dbias,
                                             multi_precision, has_bias)


@register_op("fused_bias_dropout_residual_layer_norm")
def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5,
                                           ln_epsilon=1e-5, training=True,
                                           name=None):
    """LayerNorm(residual + dropout(x + bias)) in one kernel."""
    return _IF().fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_scale, ln_bias, dropout_rate, ln_epsilon,
        training)


@register_op("fused_feedforward")
def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln_epsilon=1e-5, pre_layer_norm=False, training=True,
                      name=None):
    return _IF().fused_feedforward(
        x, linear1_weight, linear2_weight, linear1_bias, linear2_bias,
        ln1_scale, ln1_bias, ln2_scale, ln2_bias, dropout1_rate,
        dropout2_rate, activation, ln_epsilon, pre_layer_norm, training)


@register_op("block_multihead_attention", amp=False)
def block_multihead_attention(q, k_pages, v_pages, block_tables,
                              context_lens, scale=None, name=None):
    return _IF().block_multihead_attention(q, k_pages, v_pages,
                                           block_tables, context_lens,
                                           scale)


@register_op("masked_multihead_attention", amp=False)
def masked_multihead_attention(x, cache_k, cache_v, seq_len, scale=None,
                               name=None):
    return _IF().masked_multihead_attention(x, cache_k, cache_v, seq_len,
                                            scale)


@register_op("p2p_transfer", amp=False)
def p2p_transfer(x, device, name=None):
    """`x` moved to `device` (a pipeline stage's); differentiable, the
    gradient moves back (``Tensor.to``)."""
    return x.to(resolve_device(device))


@register_op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(hidden, weight, labels, transpose_weight=False,
                               chunk_size=4096, name=None):
    """Mean softmax cross-entropy of ``hidden @ weight`` against int
    labels without materializing the [T, V] logits."""
    return _F().fused_linear_cross_entropy(hidden, weight, labels,
                                           transpose_weight, chunk_size)
