"""Elementwise and binary math: the counterpart of
``paddle_tpu/ops/impl/math.py``, each op a call into ``torch``, with the
JAX package's result types (``_common``: a Python float meeting an
integer tensor gives float64, a floating function of int32 computes in
float32 and of int64 in float64). ``mod`` / ``remainder`` are floor-mod
(the result takes the divisor's sign), as ``jnp.mod`` is.
"""

from __future__ import annotations

import torch

from ...framework.dtype import convert_dtype
from ..registry import register_op
from ._common import both, inexact, is_scalar, lift, pair


def _def(name, body, inplace=False):
    """Register `body` (x, name=None) as op `name` of this module."""
    body.__name__ = body.__qualname__ = name
    body.__module__ = __name__
    api = register_op(name, inplace=inplace)(body)
    globals()[name] = api
    return api


def _unary_float(name, fn, inplace=False):
    """A floating function of one tensor (integers in ``inexact``'s
    type)."""
    _def(name, lambda x, name=None: fn(inexact(x)), inplace)


def _unary(name, fn, inplace=False):
    _def(name, lambda x, name=None: fn(x), inplace)


def _float_pair(x, y):
    """(x, y) promoted, then in the floating type a true division of the
    two computes in."""
    x, y = both(x, y)
    rt = torch.result_type(x, y)
    if not (rt.is_floating_point or rt.is_complex):
        rt = torch.float64 if rt == torch.int64 else torch.float32
    return x.to(rt), y.to(rt)


@register_op("add", inplace=True)
def add(x, y, name=None):
    x, y = pair(x, y)
    return x + y


@register_op("subtract", inplace=True)
def subtract(x, y, name=None):
    x, y = pair(x, y)
    return x - y


@register_op("multiply", inplace=True)
def multiply(x, y, name=None):
    x, y = pair(x, y)
    return x * y


@register_op("divide", inplace=True)
def divide(x, y, name=None):
    x, y = _float_pair(x, y)
    return x / y


@register_op("floor_divide")
def floor_divide(x, y, name=None):
    x, y = pair(x, y)
    return x // y


@register_op("mod", inplace=True)
def mod(x, y, name=None):
    x, y = both(x, y)
    return torch.remainder(x, y)


@register_op("remainder", inplace=True)
def remainder(x, y, name=None):
    x, y = both(x, y)
    return torch.remainder(x, y)


@register_op("pow")
def pow(x, y, name=None):  # noqa: A001
    x, y = pair(x, y)
    return x ** y


@register_op("float_power")
def float_power(x, y, name=None):
    x, y = both(x, y)
    x, y = inexact(x), inexact(y)
    rt = torch.result_type(x, y)
    return torch.pow(x.to(rt), y.to(rt))


def _minmax(fn):
    def op(x, y, name=None):
        x, y = both(x, y)
        rt = torch.result_type(x, y)
        return fn(x.to(rt), y.to(rt))
    return op


for _n, _f in (("maximum", torch.maximum), ("minimum", torch.minimum),
               ("fmax", torch.fmax), ("fmin", torch.fmin)):
    _def(_n, _minmax(_f))

for _n, _f, _ip in (
        ("exp", torch.exp, True), ("expm1", torch.expm1, False),
        ("log", torch.log, False), ("log2", torch.log2, False),
        ("log10", torch.log10, False), ("log1p", torch.log1p, False),
        ("sqrt", torch.sqrt, True), ("rsqrt", torch.rsqrt, True),
        ("reciprocal", torch.reciprocal, True),
        ("sin", torch.sin, False), ("cos", torch.cos, False),
        ("tan", torch.tan, False), ("asin", torch.asin, False),
        ("acos", torch.acos, False), ("atan", torch.atan, False),
        ("sinh", torch.sinh, False), ("cosh", torch.cosh, False),
        ("tanh", torch.tanh, True), ("asinh", torch.asinh, False),
        ("acosh", torch.acosh, False), ("atanh", torch.atanh, False),
        ("erf", torch.erf, False), ("erfinv", torch.erfinv, True),
        ("lgamma", torch.lgamma, False), ("digamma", torch.digamma, False),
        ("gammaln", torch.lgamma, False), ("i0", torch.i0, False),
        ("i0e", torch.special.i0e, False), ("i1", torch.special.i1, False),
        ("i1e", torch.special.i1e, False),
        ("rad2deg", torch.rad2deg, False),
        ("deg2rad", torch.deg2rad, False),
        ("angle", torch.angle, False)):
    _unary_float(_n, _f, _ip)

for _n, _f, _ip in (
        ("square", torch.square, False), ("abs", torch.abs, False),
        ("sign", torch.sign, False), ("sgn", torch.sgn, False),
        ("neg", torch.neg, False), ("floor", torch.floor, True),
        ("ceil", torch.ceil, True), ("trunc", torch.trunc, False),
        ("conj", torch.conj_physical, False)):
    _unary(_n, _f, _ip)
del _n, _f, _ip


@register_op("atan2")
def atan2(x, y, name=None):
    x, y = _float_pair(x, y)
    return torch.atan2(x, y)


@register_op("round")
def round(x, decimals=0, name=None):  # noqa: A001
    if not x.dtype.is_floating_point:
        return x.clone()
    return torch.round(x, decimals=decimals)


@register_op("frac")
def frac(x, name=None):
    return x - torch.trunc(x)


@register_op("polygamma")
def polygamma(x, n, name=None):
    return torch.polygamma(int(n), inexact(x))


@register_op("clip", inplace=True)
def clip(x, min=None, max=None, name=None):  # noqa: A002
    if min is None and max is None:
        return x.clone()
    x = lift(x, *(v for v in (min, max) if is_scalar(v)))
    return torch.clamp(x, min, max)


@register_op("lerp", inplace=True)
def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    x = lift(x, weight) if is_scalar(weight) else x
    return x + weight * (y - x)


@register_op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    x = lift(x, scale_a, scale_b)
    return scale_b * torch.tanh(scale_a * x)


@register_op("multiplex")
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@register_op("logit")
def logit(x, eps=None, name=None):
    x = inexact(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


@register_op("logaddexp")
def logaddexp(x, y, name=None):
    x, y = _float_pair(x, y)
    return torch.logaddexp(x, y)


@register_op("heaviside")
def heaviside(x, y, name=None):
    x, y = both(x, y)
    rt = torch.result_type(x, y)
    return torch.heaviside(x.to(rt), y.to(rt))


@register_op("gcd")
def gcd(x, y, name=None):
    return torch.gcd(*both(x, y))


@register_op("lcm")
def lcm(x, y, name=None):
    return torch.lcm(*both(x, y))


@register_op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


@register_op("real")
def real(x, name=None):
    return torch.real(x) if x.is_complex() else x.clone()


@register_op("imag")
def imag(x, name=None):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@register_op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan, posinf, neginf)


@register_op("scale", inplace=True)
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = lift(x, scale, bias)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_op("increment")
def increment(x, value=1.0, name=None):
    return lift(x, value) + value


@register_op("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return beta * input + alpha * torch.matmul(x, y)


@register_op("inner")
def inner(x, y, name=None):
    return torch.inner(*both(x, y))


@register_op("outer")
def outer(x, y, name=None):
    x, y = both(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op("kron")
def kron(x, y, name=None):
    return torch.kron(*both(x, y))


@register_op("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@register_op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def _scan_dtype(x, dtype):
    """A cumulative op's type: `dtype`, else x's (bool sums in int64),
    as ``jnp.cumsum`` keeps it."""
    d = convert_dtype(dtype)
    if d is not None:
        return d
    return torch.int64 if x.dtype == torch.bool else x.dtype


@register_op("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, int(axis), dtype=_scan_dtype(x, dtype))


@register_op("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, int(dim), dtype=_scan_dtype(x, dtype))


def _cum_extreme(fn, x, axis, dtype):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = fn(x, int(axis))
    return vals, idx.to(convert_dtype(dtype))


@register_op("cummax")
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummax, x, axis, dtype)


@register_op("cummin")
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


@register_op("logcumsumexp")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(inexact(x), int(axis))


@register_op("add_n")
def add_n(inputs, name=None):
    """Sum of a list of same-shape tensors."""
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out
