"""The fused inference ops: the counterpart of
``paddle_tpu/ops/impl/fused_inference.py`` (the non-vendor entries of
Paddle's ``fused_ops.yaml``), all 24 under the JAX names.

Each op is the JAX op's composition in plain PyTorch (the JAX package
leaves the fusion to XLA; none of these reaches a Pallas kernel), except
that ``fused_dot_product_attention`` and ``qkv_unpack_mha`` go through
the port's ``nn.functional.scaled_dot_product_attention``: the flash
kernel wherever the JAX op reaches its flash attention (no mask, no
active dropout). ``multihead_matmul`` and
``variable_length_memory_efficient_attention`` keep JAX's explicit
composition: scores masked with ``finfo(dtype).min`` (a row with no
valid key averages every value, as in JAX), causal masks top-left
aligned. The activations are ``jax.nn``'s (``gelu`` is the tanh form).
``fused_dropout_add`` draws its mask from the port's generators
(``framework.random``; a fixed seed from a generator of its own), so its
draws are not JAX's. ``fp8_fp8_half_gemm_fused`` rounds its operands
through ``torch.float8_e4m3fn`` with ``ml_dtypes``' overflow rule (NaN,
where torch's cast saturates) and keeps the product and its epilogue in
float32 until one final cast.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ...framework.random import default_generator
from ..registry import register_op

_ACTS = {
    "relu": torch.relu, "gelu": lambda x: _F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "silu": _F.silu,
    "swish": _F.silu, "identity": lambda x: x, "none": lambda x: x,
    "": lambda x: x, "leaky_relu": lambda x: _F.leaky_relu(x, 0.01),
}


def _act(name):
    return _ACTS[(name or "identity").lower()]


def _layer_norm(h, scale=None, bias=None, eps=1e-5):
    """Last-axis LayerNorm: statistics in float32 for 16-bit inputs (the
    input's own type otherwise), normalized value cast to the input's
    type, then scale and bias."""
    hf = h.float() if h.dtype in (torch.bfloat16, torch.float16) else h
    mean = hf.mean(dim=-1, keepdim=True)
    var = hf.var(dim=-1, keepdim=True, unbiased=False)
    out = ((hf - mean) / torch.sqrt(var + eps)).to(h.dtype)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def _fc_impl(input, w, bias=None, in_num_col_dims=1,  # noqa: A002
             activation_type="", padding_weights=False, name=None):
    """Flatten the dims from in_num_col_dims on, matmul, bias,
    activation."""
    lead = tuple(int(d) for d in input.shape[:in_num_col_dims])
    flat = math.prod(int(d) for d in input.shape[in_num_col_dims:])
    out = input.reshape(-1, flat) @ w
    if bias is not None:
        out = out + bias
    out = _act(activation_type)(out)
    return out.reshape(lead + (w.shape[-1],))


fc = register_op("fc")(_fc_impl)


@register_op("fused_dropout_add")
def fused_dropout_add(x, y, p=0.5, is_test=False, mode="upscale_in_train",
                      seed=None, fix_seed=False, name=None):
    """dropout(x) + y."""
    if is_test or p == 0.0:
        if mode == "downscale_in_infer" and is_test:
            return x * (1.0 - p) + y
        return x + y
    if fix_seed and seed is not None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = default_generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero) + y
    return torch.where(keep, x, zero) + y


@register_op("fused_dot_product_attention")
def fused_dot_product_attention(q, k, v, mask=None, scaling_factor=None,
                                dropout_probability=0.0, is_training=False,
                                is_causal_masking=False, name=None):
    """Attention over [B, S, H, D] through the port's
    ``scaled_dot_product_attention`` (the flash kernel when unmasked and
    not dropping). scaling_factor is taken and, as in JAX, not applied."""
    from ...nn.functional.attention import scaled_dot_product_attention
    return scaled_dot_product_attention(
        q, k, v, attn_mask=mask,
        dropout_p=dropout_probability if is_training else 0.0,
        is_causal=is_causal_masking)


def _fused_elementwise(binop):
    def impl(x, y, axis=-1, fuse_alpha=1.0, fuse_beta=1.0,
             fused_output_scale=1.0, act="", name=None):
        out = _act(act)(binop(x, y))
        if fused_output_scale != 1.0:
            out = out * fused_output_scale
        return out
    return impl


fused_elementwise_add = register_op("fused_elementwise_add")(
    _fused_elementwise(torch.add))
fused_elementwise_sub = register_op("fused_elementwise_sub")(
    _fused_elementwise(torch.subtract))
fused_elementwise_mul = register_op("fused_elementwise_mul")(
    _fused_elementwise(torch.multiply))
fused_elementwise_div = register_op("fused_elementwise_div")(
    _fused_elementwise(torch.divide))


def _fused_elemwise_activation_impl(x, y,
                                    functor_list=("elementwise_add", "relu"),
                                    axis=-1, scale=0.0, name=None):
    """The binary and unary functors applied in order."""
    binops = {"elementwise_add": torch.add, "elementwise_sub": torch.subtract,
              "elementwise_mul": torch.multiply}
    out = None
    for f in functor_list:
        if f in binops:
            out = binops[f](x, y) if out is None else binops[f](out, y)
        elif f.startswith("scale"):
            out = (x if out is None else out) * scale
        else:
            out = _act(f)(x if out is None else out)
    return out


fused_elemwise_activation = register_op("fused_elemwise_activation")(
    _fused_elemwise_activation_impl)


@register_op("fused_elemwise_add_activation")
def fused_elemwise_add_activation(x, y, functor_list=("elementwise_add",
                                                      "relu"),
                                  axis=-1, name=None):
    return _fused_elemwise_activation_impl(x, y, functor_list, axis)


@register_op("skip_layernorm")
def skip_layernorm(x, y, scale, bias, epsilon=1e-5, begin_norm_axis=-1,
                   name=None):
    """layer_norm(x + y)."""
    return _layer_norm(x + y, scale, bias, epsilon)


@register_op("fused_bias_residual_layernorm")
def fused_bias_residual_layernorm(x, bias=None, residual=None,
                                  norm_weight=None, norm_bias=None,
                                  epsilon=1e-5, residual_alpha=1.0,
                                  begin_norm_axis=-1, quant_scale=-1.0,
                                  quant_round_type=0, quant_max_bound=0.0,
                                  quant_min_bound=0.0, name=None):
    """(LN(x + bias + alpha residual), the pre-norm sum)."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual_alpha * residual
    return _layer_norm(h, norm_weight, norm_bias, epsilon), h


@register_op("add_group_norm_silu")
def add_group_norm_silu(x, residual=None, scale=None, bias=None,
                        epsilon=1e-5, groups=32, data_format="NHWC",
                        activation="silu", name=None):
    """(silu(group_norm(x + residual)), x + residual); statistics in
    float32."""
    h = x if residual is None else x + residual
    hh = torch.movedim(h, 1, -1) if data_format == "NCHW" else h
    n, c = hh.shape[0], hh.shape[-1]
    g = hh.reshape(n, -1, groups, c // groups).float()
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(hh.shape) \
        .to(hh.dtype)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    if activation == "silu":
        out = _F.silu(out)
    if data_format == "NCHW":
        out = torch.movedim(out, -1, 1)
    return out, h


@register_op("fused_fc_elementwise_layernorm")
def fused_fc_elementwise_layernorm(x, w, y, bias0=None, scale=None,
                                   bias1=None, x_num_col_dims=1,
                                   activation_type="", epsilon=1e-5,
                                   begin_norm_axis=1, name=None):
    """LN(fc(x) + y)."""
    h = _fc_impl(x, w, bias0, x_num_col_dims, activation_type)
    return _layer_norm(h + y, scale, bias1, epsilon)


@register_op("fused_embedding_eltwise_layernorm")
def fused_embedding_eltwise_layernorm(ids_list, embs_list, bias, scale,
                                      epsilon=1e-5, name=None):
    """LN(sum_i emb_i[ids_i])."""
    h = None
    for ids, emb in zip(ids_list, embs_list):
        e = emb[ids.long()]
        h = e if h is None else h + e
    return _layer_norm(h, scale, bias, epsilon)


@register_op("multihead_matmul")
def multihead_matmul(input, w, bias, bias_qk=None, transpose_q=False,  # noqa: A002
                     transpose_k=True, transpose_v=False, alpha=1.0,
                     head_number=1, name=None):
    """Packed-QKV attention: input [B, S, hidden], w [hidden, 3, N, H]
    (any shape of those elements), bias [3, N, H]; scores scaled by
    alpha, plus bias_qk, softmax; -> [B, S, N * H]."""
    b, s, _ = input.shape
    hidden = w.shape[0]
    qkv = torch.einsum("bsh,hcnd->bcsnd", input,
                       w.reshape(hidden, 3, head_number, -1))
    qkv = qkv + bias.reshape(1, 3, 1, head_number, -1)
    q, k, v = (qkv[:, i].transpose(1, 2) for i in range(3))  # [B, N, S, H]
    scores = torch.einsum("bnsh,bnth->bnst", q, k) * alpha
    if bias_qk is not None:
        scores = scores + bias_qk
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnst,bnth->bnsh", p, v)
    return out.transpose(1, 2).reshape(b, s, -1)


@register_op("qkv_unpack_mha")
def qkv_unpack_mha(q, k, v, src_mask=None, name=None):
    """Attention from separate q/k/v [B, S, N, H] (the flash kernel when
    unmasked)."""
    from ...nn.functional.attention import scaled_dot_product_attention
    return scaled_dot_product_attention(q, k, v, attn_mask=src_mask)


@register_op("fused_scale_bias_add_relu")
def fused_scale_bias_add_relu(x1, scale1, bias1, x2, scale2=None, bias2=None,
                              fuse_dual=False, exhaustive_search=False,
                              name=None):
    """relu(x1 s1 + b1 + (x2 s2 + b2 if fuse_dual else x2))."""
    lhs = x1 * scale1 + bias1
    rhs = x2 * scale2 + bias2 if fuse_dual else x2
    return torch.relu(lhs + rhs)


@register_op("blha_get_max_len")
def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None,
                     name=None):
    """(max encoder length, max decoder length)."""
    return seq_lens_encoder.max(), seq_lens_decoder.max()


@register_op("fused_token_prune")
def fused_token_prune(attn, x, mask, new_mask, keep_first_token=True,
                      keep_order=False, name=None):
    """Keep the K = new_mask.shape[2] tokens with the most attention mass
    (attn [B, N, S, S] summed over heads and rows); x [B, S, C].
    Returns (the kept rows [B, K, C], their indices int64)."""
    k = new_mask.shape[2]
    scores = attn.sum(dim=(1, 2))                     # [B, S] column mass
    if keep_first_token:
        scores = scores.clone()
        scores[:, 0] = float("inf")
    top = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    if keep_order:
        top = torch.sort(top, dim=1).values
    gathered = torch.take_along_dim(x, top[:, :, None], dim=1)
    return gathered, top.to(torch.int64)


@register_op("max_pool2d_v2")
def max_pool2d_v2(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                  data_format="NCHW", global_pooling=False, adaptive=False,
                  name=None):
    """max_pool2d's semantics (global_pooling: the max over H and W)."""
    from ...nn import functional as F
    if global_pooling:
        return x.amax(dim=(2, 3) if data_format == "NCHW" else (1, 2),
                      keepdim=True)
    return F.max_pool2d(x, kernel_size, stride=stride, padding=padding,
                        ceil_mode=ceil_mode, data_format=data_format)


@register_op("variable_length_memory_efficient_attention")
def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0,
                                               name=None):
    """Attention with per-batch valid key lengths, q/k/v [B, N, S, H]:
    keys at or past kv_seq_lens[b] (and, causal, past the row's own
    position, top-left aligned) take finfo.min, then the additive mask,
    then softmax."""
    b, n, s, h = query.shape
    t = key.shape[2]
    scale = scale or (1.0 / math.sqrt(h))
    scores = torch.einsum("bnsh,bnth->bnst", query, key) * scale
    kv_valid = torch.arange(t, device=query.device)[None, :] < \
        kv_seq_lens.reshape(b, 1)
    neg = torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                       device=scores.device)
    scores = torch.where(kv_valid[:, None, None, :], scores, neg)
    if causal:
        cm = torch.tril(torch.ones(s, t, dtype=torch.bool,
                                   device=query.device))
        scores = torch.where(cm[None, None], scores, neg)
    if mask is not None:
        scores = scores + mask
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bnst,bnth->bnsh", p, value)


@register_op("gemm_epilogue")
def gemm_epilogue(x, y, bias, trans_x=False, trans_y=False,
                  activation="none", name=None):
    """act(x @ y + bias), each operand optionally transposed."""
    a = x.transpose(-1, -2) if trans_x else x
    b = y.transpose(-1, -2) if trans_y else y
    return _act(activation)(a @ b + bias)


@register_op("resnet_unit")
def resnet_unit(x, filter_x, scale_x, bias_x, mean_x, var_x,
                z=None, filter_z=None, scale_z=None, bias_z=None,
                mean_z=None, var_z=None, stride=1, padding=1, dilation=1,
                group=1, momentum=0.9, epsilon=1e-5, data_format="NHWC",
                fuse_add=False, has_shortcut=False, use_global_stats=True,
                act="relu", name=None):
    """conv + batch norm (inference statistics), plus a shortcut conv +
    batch norm or a residual z, then the activation."""
    from ...nn import functional as F

    def conv_bn(inp, flt, sc, bs, mn, vr):
        xi = torch.movedim(inp, -1, 1) if data_format == "NHWC" else inp
        o = F.conv2d(xi, flt, stride=stride, padding=padding,
                     dilation=dilation, groups=group)
        o = torch.movedim(o, 1, -1) if data_format == "NHWC" else o
        return (o - mn) / torch.sqrt(vr + epsilon) * sc + bs

    out = conv_bn(x, filter_x, scale_x, bias_x, mean_x, var_x)
    if has_shortcut and z is not None:
        out = out + conv_bn(z, filter_z, scale_z, bias_z, mean_z, var_z)
    elif fuse_add and z is not None:
        out = out + z
    return _act(act)(out)


# the magnitude past which a cast to float8_e4m3fn overflows: the
# midpoint between its largest finite value, 448, and the next step, 480
# (464 itself rounds to even, down to 448)
_E4M3_OVERFLOW = 464.0


def to_e4m3fn(x):
    """x rounded through float8_e4m3fn as ``ml_dtypes`` (the JAX
    package's) casts, returned in bfloat16 (which holds every e4m3 value):
    round to nearest even, and NaN for a magnitude past 464 or an
    infinity (e4m3fn has none), where ``torch``'s own cast saturates to
    +-448."""
    q = x.to(torch.float8_e4m3fn).to(torch.bfloat16)
    over = x.abs() > _E4M3_OVERFLOW          # NaN compares False: kept
    return torch.where(over, torch.tensor(float("nan"), dtype=q.dtype,
                                          device=q.device), q)


@register_op("fp8_fp8_half_gemm_fused", amp=False)
def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0, output_dtype=None,
                            activation_type="identity", name=None):
    """x and y rounded through float8_e4m3fn (``to_e4m3fn``), their
    product accumulated in float32, times scale, plus bias (rounded to
    bfloat16 first), the activation, one cast to output_dtype (default
    bfloat16): the float32 epilogue the JAX op computes on the CPU."""
    xq, yq = to_e4m3fn(x), to_e4m3fn(y)
    a = xq.transpose(-1, -2) if transpose_x else xq
    b = yq.transpose(-1, -2) if transpose_y else yq
    out = torch.matmul(a.float(), b.float()) * scale
    if bias is not None:
        out = out + bias.to(torch.bfloat16).float()
    out = _act(activation_type)(out)
    from ...framework import dtype as dtypes
    return out.to(dtypes.convert_dtype(output_dtype) if output_dtype
                  is not None else torch.bfloat16)


__all__ = ["fc", "fused_dropout_add", "fused_dot_product_attention",
           "fused_elementwise_add", "fused_elementwise_sub",
           "fused_elementwise_mul", "fused_elementwise_div",
           "fused_elemwise_activation", "fused_elemwise_add_activation",
           "skip_layernorm", "fused_bias_residual_layernorm",
           "add_group_norm_silu", "fused_fc_elementwise_layernorm",
           "fused_embedding_eltwise_layernorm", "multihead_matmul",
           "qkv_unpack_mha", "fused_scale_bias_add_relu", "blha_get_max_len",
           "fused_token_prune", "max_pool2d_v2",
           "variable_length_memory_efficient_attention", "gemm_epilogue",
           "resnet_unit", "fp8_fp8_half_gemm_fused"]
