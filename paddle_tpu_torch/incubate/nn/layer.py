"""The fused layers: the counterparts of ``paddle_tpu/incubate/nn/layer.py``
— ``FusedLinear`` (:23), ``FusedDropoutAdd`` (:41),
``FusedBiasDropoutResidualLayerNorm`` (:57), ``FusedMultiHeadAttention``
(:82), ``FusedFeedForward`` (:153), ``FusedTransformerEncoderLayer``
(:211) and ``FusedMultiTransformer`` (:236). Parameters keep the JAX
names and layouts (``qkv_weight`` [3, N, Hd, E], ``linear_weight`` [E, E],
``ln_scale``, ...; ``FusedMultiTransformer``'s layers are ``layer_{i}``),
so ``weights.from_paddle_tpu_state`` carries them across. Constructors
take the JAX parameters in order (a ``*_attr`` of False drops that
parameter where JAX drops it; ``name``, ``nranks`` and ``ring_id`` are
ignored), ``device=`` (default: the CUDA card) and ``dtype=`` keyword-only
after them.

The layers compute what the JAX layers compute, through the functionals:
attention through ``F.scaled_dot_product_attention`` (the flash kernel
without a mask in eval), pre-norms through ``F.layer_norm``, and the
post-norm residual tails of the attention and FFN blocks through the bdrln
op (``functional._residual_tail``). The FFN layer's activation is
``nn.functional``'s by name (``gelu``: exact), unlike the functional
``fused_feedforward``'s ``jax.nn`` names (``gelu``: tanh), as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn import functional as NF
from ...nn.layers import wants_param
from . import functional as F


def _param(shape, attr, what, kw, fill=None):
    """A parameter of `shape` (empty, or filled with `fill`), or None when
    `attr` is False."""
    if not wants_param(attr, what):
        return None
    t = torch.empty(shape, **kw) if fill is None else \
        torch.full(shape, float(fill), **kw)
    return nn.Parameter(t)


class FusedLinear(nn.Module):
    """x @ weight + bias in one op; weight [in, out], or [out, in] with
    transpose_weight."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.transpose_weight = transpose_weight
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = _param(shape, weight_attr, "weight_attr", kw)
        self.bias = _param([out_features], bias_attr, "bias_attr", kw, 0)

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias,
                              self.transpose_weight)


class FusedDropoutAdd(nn.Module):
    """dropout(x) + y; dropout only in training mode (its mode as in
    ``F.dropout``). No parameters, so no device of its own."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F.fused_dropout_add(x, y, p=self.p, training=self.training,
                                   mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """out = LayerNorm(residual + dropout(x + linear_bias)) * ln_scale +
    ln_bias, through the bdrln op; dropout only in training mode."""

    NORM_SCALES = ("ln_scale",)      # drawn as ones by ``weights``

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = _param([embed_dim], bias_attr, "bias_attr", kw, 0)
        self.ln_scale = _param([embed_dim], weight_attr, "weight_attr", kw, 1)
        self.ln_bias = _param([embed_dim], None, "", kw, 0)

    def forward(self, x, residual, generator=None):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias,
            dropout_rate=self.dropout_rate if self.training else 0.0,
            ln_epsilon=self.epsilon, generator=generator)


class FusedMultiHeadAttention(nn.Module):
    """Self-attention over the query with a pre- or post-LayerNorm, the
    packed QKV projection, the output projection, dropout and the residual
    (``F.fused_multi_head_attention``). key, value and cache are taken and
    ignored, as in JAX."""

    NORM_SCALES = ("pre_ln_scale", "ln_scale")

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        e, n, hd = embed_dim, num_heads, self.head_dim
        wants_param(pre_ln_bias_attr, "pre_ln_bias_attr")   # JAX ignores
        wants_param(ln_bias_attr, "ln_bias_attr")           # these two
        self.qkv_weight = _param([3, n, hd, e], qkv_weight_attr,
                                 "qkv_weight_attr", kw)
        self.qkv_bias = _param([3, n, hd], qkv_bias_attr, "qkv_bias_attr",
                               kw, 0)
        self.linear_weight = _param([e, e], linear_weight_attr,
                                    "linear_weight_attr", kw)
        self.linear_bias = _param([e], linear_bias_attr, "linear_bias_attr",
                                  kw, 0)
        self.pre_ln_scale = _param([e], pre_ln_scale_attr,
                                   "pre_ln_scale_attr", kw, 1)
        self.pre_ln_bias = _param([e], None, "", kw, 0)
        self.ln_scale = _param([e], ln_scale_attr, "ln_scale_attr", kw, 1)
        self.ln_bias = _param([e], None, "", kw, 0)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self.epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self.epsilon, training=self.training,
            num_heads=self.num_heads)


class FusedFeedForward(nn.Module):
    """LN1 (pre-norm) + linear1 + activation + dropout + linear2 +
    residual dropout-add (+ LN2 post-norm, the bdrln op). The activation
    is ``nn.functional``'s by name (``gelu``: exact)."""

    NORM_SCALES = ("ln1_scale", "ln2_scale")

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        d, f = d_model, dim_feedforward
        self.linear1_weight = _param([d, f], linear1_weight_attr,
                                     "linear1_weight_attr", kw)
        self.linear1_bias = _param([f], linear1_bias_attr,
                                   "linear1_bias_attr", kw, 0)
        self.linear2_weight = _param([f, d], linear2_weight_attr,
                                     "linear2_weight_attr", kw)
        self.linear2_bias = _param([d], linear2_bias_attr,
                                   "linear2_bias_attr", kw, 0)
        self.ln1_scale = _param([d], ln1_scale_attr, "ln1_scale_attr", kw, 1)
        self.ln1_bias = _param([d], ln1_bias_attr, "ln1_bias_attr", kw, 0)
        self.ln2_scale = _param([d], ln2_scale_attr, "ln2_scale_attr", kw, 1)
        self.ln2_bias = _param([d], ln2_bias_attr, "ln2_bias_attr", kw, 0)

    def forward(self, src, cache=None):
        x = src
        if self.normalize_before:
            x = NF.layer_norm(x, [self.d_model], self.ln1_scale,
                              self.ln1_bias, self.epsilon)
        h = getattr(NF, self.activation)(
            NF.linear(x, self.linear1_weight, self.linear1_bias))
        h = NF.dropout(h, self.act_dropout_rate if self.training else 0.0,
                       training=self.training)
        return F._residual_tail(
            torch.matmul(h, self.linear2_weight), src, self.linear2_bias,
            self.dropout_rate, self.training, not self.normalize_before,
            self.ln2_scale, self.ln2_bias, self.epsilon)


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``. weight_attr
    and bias_attr are taken and not used, as in JAX (a ParamAttr
    raises)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        wants_param(weight_attr, "weight_attr")
        wants_param(bias_attr, "bias_attr")
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """A stack of ``FusedTransformerEncoderLayer``s (pre-LN by default),
    registered as ``layer_0``, ``layer_1``, ... The number of layers is
    num_layers, or the length of qkv_weight_attrs when that is a list
    (else 1). As in JAX, the per-layer attrs and epsilon are taken and not
    used (a ParamAttr in a list raises)."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, qkv_weight_attrs=None,
                 linear_weight_attrs=None, ffn_ln_scale_attrs=None,
                 ffn1_weight_attrs=None, ffn2_weight_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, ring_id=-1,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        attrs = (ln_scale_attrs, qkv_weight_attrs, linear_weight_attrs,
                 ffn_ln_scale_attrs, ffn1_weight_attrs, ffn2_weight_attrs)
        for a in attrs:
            for x in (a if isinstance(a, (list, tuple)) else [a]):
                wants_param(x, "a per-layer attr")
        if num_layers < 0:
            num_layers = (len(qkv_weight_attrs)
                          if isinstance(qkv_weight_attrs, (list, tuple))
                          else 1)
        self.num_layers = num_layers
        self.layers = []            # the same modules, in order
        for i in range(num_layers):
            lyr = FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before, **kw)
            self.add_module(f"layer_{i}", lyr)
            self.layers.append(lyr)

    def forward(self, src, attn_mask=None, caches=None, **kw):
        out = src
        for lyr in self.layers:
            out = lyr(out, src_mask=attn_mask)
        return out
