"""Fused ops: the counterparts of ``paddle_tpu/ops/impl/fused.py``'s
``fused_bias_dropout_residual_layer_norm`` (:117), ``fused_feedforward``
(:148), ``fused_rotary_position_embedding`` (:48, on the RoPE kernel),
``fused_linear`` (:79), ``fused_bias_act`` (:88),
``fused_linear_param_grad_add`` (:98),
``block_multihead_attention`` (:215, on the paged decode kernel) and
``masked_multihead_attention`` (:237, plain, as in JAX), and of
``paddle_tpu/incubate/nn/functional/__init__.py``'s ``fused_layer_norm``,
``fused_dropout_add``, ``fused_matmul_bias`` and
``fused_linear_activation`` (both ``gemm_epilogue``,
``ops/impl/fused_inference.py:336``), ``fused_multi_head_attention`` and
``fused_multi_transformer``.

``fused_bias_dropout_residual_layer_norm`` is the bdrln op
(``ops.kernels.BiasDropoutResidualLN``: the CUDA kernel for CUDA tensors,
its plain version on the CPU, for every h; the JAX package takes its TPU
kernel only when h % 128 == 0 and XLA otherwise). Its dropout seed is one
int in [0, 2^31 - 1) drawn per call while training with p > 0, as the JAX
op draws it. ``fused_feedforward`` keeps its two GEMMs as ``torch.matmul``
(the JAX package leaves them to XLA), runs the ``swiglu`` activation
through the SwiGLU kernel and the others in plain PyTorch (the JAX op
takes any ``jax.nn`` activation by name; ``_ACTIVATIONS`` maps the
elementwise ones to their ``torch.nn.functional`` counterparts, ``gelu``
being JAX's default tanh approximation, as in ``fused_bias_act`` and the
GEMM epilogues), dropout1 and the pre-norm tail in plain PyTorch, and the
post-norm tail through the bdrln op; so does the post-norm tail of
``fused_multi_head_attention``. ``fused_multi_transformer`` takes its
activation from ``nn.functional`` by name (``gelu``: exact), as JAX does.
Attention goes through ``F.scaled_dot_product_attention`` (the flash
kernel without a mask or active dropout). Every function takes the JAX
op's parameters in order (``name``, ``ring_id`` and the cache arguments
that JAX also ignores are taken and ignored); ``generator=`` is
keyword-only after them where dropout draws.
"""

from __future__ import annotations

import torch

from ...framework.random import next_seed
from ...nn import functional as F
from ...ops import kernels as _k
from ...ops.kernels.bias_dropout_residual_ln import _ln

_F = torch.nn.functional
# jax.nn name -> the same function in torch (jax.nn's defaults: gelu
# approximate=True, leaky_relu slope 0.01, elu/celu alpha 1)
_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": _F.relu6,
    "gelu": lambda t: _F.gelu(t, approximate="tanh"),
    "silu": _F.silu,
    "swish": _F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": _F.elu,
    "selu": _F.selu,
    "celu": _F.celu,
    "leaky_relu": _F.leaky_relu,
    "softplus": _F.softplus,
    "soft_sign": _F.softsign,
    "log_sigmoid": _F.logsigmoid,
    "hard_sigmoid": _F.hardsigmoid,
    "hard_silu": _F.hardswish,
    "hard_swish": _F.hardswish,
    "hard_tanh": _F.hardtanh,
    "mish": _F.mish,
}


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, name=None, *,
                                           generator=None):
    """out = LayerNorm(residual + dropout(x + bias)) * ln_scale + ln_bias
    over the last dim, in one kernel. ln_scale/ln_bias default to ones and
    zeros; bias, ln_scale and ln_bias share one dtype. generator draws the
    dropout seed (default: the CPU generator of ``framework.random``)."""
    h = x.shape[-1]
    if ln_scale is None:
        ln_scale = torch.ones(h, dtype=x.dtype, device=x.device)
    if ln_bias is None:
        ln_bias = torch.zeros(h, dtype=x.dtype, device=x.device)
    p = float(dropout_rate) if training else 0.0
    seed = next_seed(generator) if p > 0.0 else 0
    return _k.BiasDropoutResidualLN.apply(x, bias, residual, ln_scale,
                                          ln_bias, ln_epsilon, p, seed)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None, *,
                      generator=None):
    """The transformer FFN block:

        residual = x
        out = LN1(x) if pre_layer_norm else x
        out = dropout1(act(out @ linear1_weight + linear1_bias))
        out = out @ linear2_weight
        out = residual + dropout2(out + linear2_bias)   # then LN2 post-norm

    Weights [in, out]; "swiglu" splits the first product's output in two
    halves (gate, up). generator (on x's device; default: the device's
    generator, and the CPU's for the bdrln seed) draws the dropout masks
    and the bdrln op's seed."""
    h = x.shape[-1]
    residual = x
    out = x
    if pre_layer_norm:
        s = ln1_scale if ln1_scale is not None else torch.ones(
            h, dtype=x.dtype, device=x.device)
        b = ln1_bias if ln1_bias is not None else torch.zeros(
            h, dtype=x.dtype, device=x.device)
        out = _ln(out, s, b, ln_epsilon)
    out = F.linear(out, linear1_weight, linear1_bias)
    if activation == "swiglu":
        gate, up = out.chunk(2, dim=-1)
        out = F.swiglu(gate.contiguous(), up.contiguous())
    elif activation in _ACTIVATIONS:
        out = _ACTIVATIONS[activation](out)
    else:
        raise ValueError(f"fused_feedforward: activation {activation!r} is "
                         f"not one of {sorted(_ACTIVATIONS) + ['swiglu']}")
    p1 = float(dropout1_rate) if training else 0.0
    if p1 > 0.0:
        out = F.dropout(out, p1, training=True, generator=generator)
    return _residual_tail(torch.matmul(out, linear2_weight), residual,
                          linear2_bias, dropout2_rate, training,
                          not pre_layer_norm, ln2_scale, ln2_bias,
                          ln_epsilon, generator=generator)


def _residual_tail(out, residual, bias, p, training, post_norm, ln_scale,
                   ln_bias, epsilon, mode="upscale_in_train",
                   generator=None):
    """residual + dropout(out + bias), then LayerNorm(ln_scale, ln_bias)
    when post_norm: the post-norm tail is the bdrln op (one kernel), the
    pre-norm one plain PyTorch. Dropout in "downscale_in_infer" mode while
    training (which bdrln does not compute) is plain too."""
    p = float(p) if training else 0.0
    if post_norm and (p == 0.0 or mode == "upscale_in_train"):
        return fused_bias_dropout_residual_layer_norm(
            out, residual, bias=bias, ln_scale=ln_scale, ln_bias=ln_bias,
            dropout_rate=p, ln_epsilon=epsilon, training=training,
            generator=generator)
    if bias is not None:
        out = out + bias
    out = residual + F.dropout(out, p, training=training, mode=mode,
                               generator=generator)
    if post_norm:
        out = F.layer_norm(out, out.shape[-1], ln_scale, ln_bias, epsilon)
    return out


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """Rotate-half RoPE of q (and k) by [S, D] or [1, S, 1, D] tables, q
    and k in one kernel launch (``F.fused_rope_qk``); v passes through
    unrotated. Returns (q, k, v), None where an input was None. As in the
    JAX op, position_ids and use_neox_rotary_style are taken and ignored:
    the tables' rows are the positions, and the rotation is rotate-half."""
    def table(t):
        return (t[0, :, 0] if t.dim() == 4 else t).contiguous()

    cos, sin = table(cos), table(sin)
    if k is None:
        return F.fused_rope(q.contiguous(), cos, sin), None, v
    q, k = F.fused_rope_qk(q.contiguous(), k.contiguous(), cos, sin)
    return q, k, v


def _act(name, table):
    if name not in table:
        raise ValueError(f"activation {name!r} is not one of "
                         f"{sorted(table)}")
    return table[name]


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias); weight [in, out], or [out, in] with
    transpose_weight."""
    return F.linear(x, weight.t() if transpose_weight else weight, bias)


def fused_bias_act(x, bias=None, act_method="gelu", name=None, **kw):
    """act(x + bias) with a ``jax.nn`` activation name (``gelu``: the tanh
    form); "swiglu" and "geglu" split the last dim into (a, b) and return
    silu(a) * b or gelu(a) * b, in plain PyTorch as JAX computes them in
    XLA."""
    if bias is not None:
        x = x + bias
    if act_method in ("swiglu", "geglu"):
        a, b = x.chunk(2, dim=-1)
        inner = _F.silu if act_method == "swiglu" else _ACTIVATIONS["gelu"]
        return inner(a) * b
    return _act(act_method, _ACTIVATIONS)(x)


def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True,
                                name=None):
    """A Linear layer's weight gradient, added to an accumulated one:
    dweight + x^T dout over the flattened rows ([in, out]), and with
    has_bias (dbias + the column sums of dout, [out]). One
    ``torch.matmul``, as the JAX package leaves it to XLA; the products
    are in x's type whatever multi_precision says, as in JAX. Returns dw,
    or (dw, db) with has_bias."""
    x2 = x.reshape(-1, x.shape[-1])
    d2 = dout.reshape(-1, dout.shape[-1])
    dw = torch.matmul(x2.t(), d2)
    if dweight is not None:
        dw = dweight + dw
    if not has_bias:
        return dw
    db = d2.sum(0)
    return dw, (db if dbias is None else dbias + db)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5, **kw):
    """LayerNorm over the last dim (``F.layer_norm``)."""
    return F.layer_norm(x, x.shape[-1], norm_weight, norm_bias, epsilon)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      *, generator=None):
    """dropout(x) + y (``F.dropout``'s modes)."""
    return F.dropout(x, p, training=training, mode=mode,
                     generator=generator) + y


# the GEMM epilogue's activations (``_ACTS`` of fused_inference.py: gelu
# is jax.nn.gelu's tanh form), looked up lower-cased, None as identity
_GEMM_ACTS = {k: _ACTIVATIONS[k] for k in
              ("relu", "gelu", "sigmoid", "tanh", "silu", "swish",
               "leaky_relu")}
_GEMM_ACTS.update(dict.fromkeys(("identity", "none", ""), lambda t: t))


def _gemm_epilogue(x, y, bias, trans_x, trans_y, activation):
    a = x.transpose(-1, -2) if trans_x else x
    b = y.transpose(-1, -2) if trans_y else y
    out = torch.matmul(a, b)
    return _act((activation or "identity").lower(), _GEMM_ACTS)(
        out if bias is None else out + bias)


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """x @ y (each transposed over its last two dims when asked) + bias."""
    return _gemm_epilogue(x, y, bias, transpose_x, transpose_y, "none")


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu", name=None):
    """act(x @ y + bias), activation by the GEMM epilogue's names."""
    return _gemm_epilogue(x, y, bias, trans_x, trans_y, activation)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, name=None, *,
                               generator=None):
    """The fused attention block over x [B, S, E]:

        h = LN_pre(x) if pre_layer_norm else x
        q, k, v = split(h @ W_qkv + b_qkv)      # W_qkv [3, N, Hd, E] as
        out = attention(q, k, v, attn_mask)     # [3E, E] transposed, or
        out = dropout(out @ linear_weight + linear_bias)   # [E, 3E] with
        out = x + out if add_residual else out             # transpose_qkv_wb
        out = LN(out) unless pre_layer_norm

    num_heads -1 takes N from qkv_weight [3, N, Hd, E]. The post-norm
    residual tail is the bdrln op. cache_kv is taken and ignored, as in
    JAX."""
    residual = x
    h = x
    e = x.shape[-1]
    if pre_layer_norm:
        h = F.layer_norm(h, [e], pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    b, s = h.shape[0], h.shape[1]
    n = num_heads if num_heads > 0 else qkv_weight.shape[1]
    w = qkv_weight.reshape(e, 3 * e) if transpose_qkv_wb else \
        qkv_weight.reshape(3 * e, e).t()
    qkv = F.linear(h, w, None if qkv_bias is None
                   else qkv_bias.reshape(3 * e))
    qkv = qkv.reshape(b, s, 3, n, e // n)
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0,
        training=training, generator=generator)
    out = torch.matmul(out.reshape(b, s, e), linear_weight)
    if not add_residual:
        out = F.dropout(out if linear_bias is None else out + linear_bias,
                        dropout_rate if training else 0.0,
                        training=training, mode=mode, generator=generator)
        return out if pre_layer_norm else F.layer_norm(
            out, [e], ln_scale, ln_bias, ln_epsilon)
    return _residual_tail(out, residual, linear_bias, dropout_rate,
                          training, not pre_layer_norm, ln_scale, ln_bias,
                          ln_epsilon, mode=mode, generator=generator)


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, linear_weights, linear_biases,
                            ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases,
                            pre_layer_norm=True, epsilon=1e-5,
                            cache_kvs=None, time_step=None, attn_mask=None,
                            dropout_rate=0.0, activation="gelu",
                            training=False, mode=None, trans_qkvw=True,
                            ring_id=-1, name=None, *, generator=None):
    """The inference stack: per layer i, ``fused_multi_head_attention``
    (pre-LN by ln_scales[i], qkv_weights[i] [3, N, Hd, E]), then
    out + linear2(act(linear1(LN(out)))) with the ffn weights, act from
    ``nn.functional`` by name (``gelu``: exact). As in JAX the attention's
    LN takes its default epsilon, the FFN's `epsilon`; cache_kvs,
    time_step, mode and trans_qkvw are taken and ignored."""
    out = x
    act = getattr(F, activation)
    for i in range(len(qkv_weights)):
        out = fused_multi_head_attention(
            out, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm, pre_ln_scale=ln_scales[i],
            pre_ln_bias=ln_biases[i],
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training,
            generator=generator)
        h = F.layer_norm(out, [out.shape[-1]], ffn_ln_scales[i],
                         ffn_ln_biases[i], epsilon)
        h = act(F.linear(h, ffn1_weights[i],
                         ffn1_biases[i] if ffn1_biases else None))
        out = out + F.linear(h, ffn2_weights[i],
                             ffn2_biases[i] if ffn2_biases else None)
    return out


def block_multihead_attention(q, k_pages, v_pages, block_tables,
                              context_lens, scale=None, name=None):
    """Decode attention of one query token per sequence over a block-paged
    KV cache (``F.paged_attention``: the paged decode kernel). q [B, H, D]
    or [B, 1, H, D]; pages [N, page, H_kv, D]; block_tables [B, P];
    context_lens [B]."""
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(f"block_multihead_attention decodes ONE query "
                         f"token per sequence; got q seq dim {q.shape[1]}")
    return F.paged_attention(q, k_pages, v_pages, block_tables,
                             context_lens, scale=scale)


def masked_multihead_attention(x, cache_k, cache_v, seq_len, scale=None,
                               name=None):
    """Single-token attention over a dense cache: x [B, 1, H, D] is the
    query of the token written at position seq_len - 1 of cache_k/cache_v
    [B, S_max, H_kv, D]; later keys are masked. Plain PyTorch, as the JAX
    op is plain XLA (the Llama's ``_decode_attention``)."""
    from ...models.llama import _decode_attention
    b, _, h, d = x.shape
    out = _decode_attention(x, cache_k, cache_v, seq_len - 1, h,
                            cache_k.shape[2], scale=scale)
    return out.reshape(b, 1, h, d)
