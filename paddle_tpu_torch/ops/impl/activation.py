"""Activations: the counterpart of ``paddle_tpu/ops/impl/activation.py``.

``swiglu`` is the SwiGLU kernel (``ops.kernels.SwiGLU``: the CUDA kernel
on the card, its plain version on the CPU), as the JAX op routes to its
Pallas kernel on the TPU. The others are torch compositions with the JAX
package's constants (``hardsigmoid``'s slope 0.1666667, ``selu``'s
scale and alpha, ``softplus``'s threshold).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework import dtype as dtypes
from ...framework.random import default_generator
from ..registry import register_op
from ._common import inexact


@register_op("relu", inplace=True)
def relu(x, name=None):
    return torch.relu(x)


@register_op("relu6")
def relu6(x, name=None):
    return F.relu6(x)


@register_op("gelu")
def gelu(x, approximate=False, name=None):
    return F.gelu(inexact(x), approximate="tanh" if approximate else "none")


@register_op("sigmoid", inplace=True)
def sigmoid(x, name=None):
    return torch.sigmoid(inexact(x))


@register_op("silu")
def silu(x, name=None):
    return F.silu(inexact(x))


@register_op("swish")
def swish(x, name=None):
    return F.silu(inexact(x))


@register_op("hardswish")
def hardswish(x, name=None):
    return x * torch.clamp(x + 3, 0, 6) / 6


@register_op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0, 1)


@register_op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


@register_op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@register_op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@register_op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@register_op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@register_op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


@register_op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if weight.numel() > 1:
        w = weight.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if data_format == "NCHW" else \
            weight.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(x >= 0, x, w * x)


@register_op("rrelu")
def rrelu(x, lower=0.125, upper=0.333333, training=False, name=None):
    if training:
        a = torch.rand(x.shape, generator=default_generator(x.device),
                       dtype=x.dtype, device=x.device)
        a = a * (upper - lower) + lower
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


@register_op("elu", inplace=True)
def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


@register_op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("celu")
def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


@register_op("mish")
def mish(x, name=None):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


@register_op("softplus")
def softplus(x, beta=1, threshold=20, name=None):
    bx = x * beta
    safe = torch.where(bx > threshold, torch.zeros_like(bx), bx)
    return torch.where(bx > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(safe)))


@register_op("softsign")
def softsign(x, name=None):
    return x / (1 + x.abs())


@register_op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    d = dtypes.convert_dtype(dtype)
    return torch.softmax(inexact(x if d is None else x.to(d)), axis)


@register_op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    d = dtypes.convert_dtype(dtype)
    return torch.log_softmax(inexact(x if d is None else x.to(d)), axis)


@register_op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, generator=default_generator(x.device),
                   dtype=x.dtype, device=x.device)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        # straight through: y_hard forward, the softmax's gradient
        y = y + (y_hard - y).detach()
    return y


@register_op("maxout")
def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), axis + 1)


@register_op("glu")
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@register_op("swiglu")
def swiglu(x, y=None, name=None):
    """silu(x) * y through the SwiGLU kernel (row 4 of the port's
    kernels), float32 inside, in x's type; y None splits x's last dim in
    two halves."""
    from ..kernels import SwiGLU
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return SwiGLU.apply(x.contiguous(), y.contiguous())


@register_op("log_sigmoid")
def log_sigmoid(x, name=None):
    return F.logsigmoid(inexact(x))
