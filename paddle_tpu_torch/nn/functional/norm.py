"""Normalization functionals: the counterparts of
``paddle_tpu/nn/functional/norm.py`` — ``layer_norm``, ``rms_norm`` (the
RMSNorm kernel), ``batch_norm_infer``, ``batch_norm_train``,
``batch_norm``, ``group_norm``, ``instance_norm``, ``local_response_norm``
and ``spectral_norm``.

As in JAX, ``batch_norm_train`` returns the batch mean and the BIASED
batch variance, and the layer (``nn.layer.norm``) updates its running
statistics from them as ``r = m r + (1 - m) batch`` with paddle's
momentum (0.9 by default): ``torch.nn.functional.batch_norm`` takes the
opposite momentum and keeps the unbiased variance, so it is not used.
Group, instance and batch norms compute in their input's type.
"""

from __future__ import annotations

import math

import torch

from ...ops import kernels as _k
from ...ops.registry import OP_TABLE, register_op
from .attention import _dense


@register_op("layer_norm")
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


@register_op("rms_norm")
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
    out = _k.RMSNorm.apply(*_dense(x.reshape(*x.shape[:axis], n), w),
                           epsilon).reshape(x.shape)
    return out if bias is None else out + bias




def _channel_shape(x, data_format):
    """The broadcast shape of a per-channel vector against x."""
    n = x.dim()
    if data_format.startswith("NC") and n > 2:
        return (1, -1) + (1,) * (n - 2)
    return (1,) * (n - 1) + (-1,)


def _apply_norm(x, mean, var, weight, bias, epsilon, data_format):
    shape = _channel_shape(x, data_format)
    inv = torch.reciprocal(torch.sqrt(var.reshape(shape) + epsilon))
    out = (x - mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_op("batch_norm_infer")
def batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                     epsilon=1e-5, data_format="NCHW"):
    """(x - mean) / sqrt(var + eps) * weight + bias with the given
    statistics, per channel."""
    return _apply_norm(x, running_mean, running_var, weight, bias, epsilon,
                       data_format)


@register_op("batch_norm_train")
def batch_norm_train(x, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """(out, batch_mean, batch_var): x normalized by its own statistics
    over every dim but the channel's; the variance is biased. The running
    statistics are the layer's business."""
    n = x.dim()
    if data_format.startswith("NC") and n > 2:
        axes = (0,) + tuple(range(2, n))
    elif data_format.startswith("NC") and n == 2:
        axes = (0,)
    else:
        axes = tuple(range(n - 1))
    mean = x.mean(axes)
    var = x.var(axes, unbiased=False)
    out = _apply_norm(x, mean, var, weight, bias, epsilon, data_format)
    return out, mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Stateless batch norm: in training (and not use_global_stats) the
    batch statistics normalize x; else the running ones. It updates no
    statistics (the layer does), as in JAX."""
    if training and not use_global_stats:
        out, _, _ = OP_TABLE["batch_norm_train"]["api"](
            x, weight, bias, epsilon, data_format)
        return out
    return OP_TABLE["batch_norm_infer"]["api"](
        x, running_mean, running_var, weight, bias, epsilon, data_format)


@register_op("group_norm")
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each sample over each group of channels (and the spatial
    dims), then the per-channel weight and bias."""
    n = x.dim()
    if data_format.startswith("NC"):
        b, c = x.shape[0], x.shape[1]
        g = x.reshape((b, num_groups, c // num_groups) + tuple(x.shape[2:]))
        axes = tuple(range(2, g.dim()))
        pshape = (1, c) + (1,) * (n - 2)
    else:
        b, c = x.shape[0], x.shape[-1]
        g = x.reshape((b,) + tuple(x.shape[1:-1]) +
                      (num_groups, c // num_groups))
        axes = tuple(range(1, g.dim() - 2)) + (g.dim() - 1,)
        pshape = (1,) * (n - 1) + (c,)
    mean = g.mean(axes, keepdim=True)
    var = g.var(axes, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.reciprocal(torch.sqrt(var + epsilon))
           ).reshape(x.shape)
    if weight is not None:
        out = out * weight.reshape(pshape)
    if bias is not None:
        out = out + bias.reshape(pshape)
    return out


@register_op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalize each sample's each channel over its spatial dims (the
    running statistics are taken and not used, as in JAX)."""
    n = x.dim()
    axes = tuple(range(2, n)) if data_format.startswith("NC") else \
        tuple(range(1, n - 1))
    pshape = _channel_shape(x, data_format)
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    out = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        out = out * weight.reshape(pshape)
    if bias is not None:
        out = out + bias.reshape(pshape)
    return out


@register_op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of x^2 over `size` neighbouring channels)^beta
    (the window padded with zeros, size // 2 channels before)."""
    if not data_format.startswith("NC"):
        x = torch.movedim(x, -1, 1)
    sq = torch.square(x)
    half = size // 2
    pad = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = torch.nn.functional.pad(sq, pad)
    acc = torch.zeros_like(x)
    c = x.shape[1]
    for i in range(size):
        acc = acc + padded[:, i:i + c]
    out = x / torch.pow(k + alpha * acc, beta)
    if not data_format.startswith("NC"):
        out = torch.movedim(out, 1, -1)
    return out


@register_op("spectral_norm")
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight / sigma, sigma its largest singular value estimated by
    `power_iters` power iterations from u and v (weight moved so `dim`
    leads and flattened to a matrix)."""
    w = torch.movedim(weight, dim, 0).reshape(weight.shape[dim], -1)
    for _ in range(power_iters):
        v = w.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ w @ v
    return weight / sigma
