"""Comparison, logical and bitwise ops: the counterpart of
``paddle_tpu/ops/impl/logic.py`` (all registered with amp=False, as
there)."""

from __future__ import annotations

import torch

from ..registry import register_op
from ._common import both


def _binary(name, fn):
    def op(x, y, out=None, name=None):
        return fn(*both(x, y))
    op.__name__ = op.__qualname__ = name
    globals()[name] = register_op(name, amp=False)(op)


def _unary(name, fn):
    def op(x, out=None, name=None):
        return fn(x)
    op.__name__ = op.__qualname__ = name
    globals()[name] = register_op(name, amp=False)(op)


for _n, _f in (("equal", torch.eq), ("not_equal", torch.ne),
               ("greater_than", torch.gt), ("greater_equal", torch.ge),
               ("less_than", torch.lt), ("less_equal", torch.le),
               ("logical_and", torch.logical_and),
               ("logical_or", torch.logical_or),
               ("logical_xor", torch.logical_xor),
               ("bitwise_and", torch.bitwise_and),
               ("bitwise_or", torch.bitwise_or),
               ("bitwise_xor", torch.bitwise_xor)):
    _binary(_n, _f)

for _n, _f in (("logical_not", torch.logical_not),
               ("bitwise_not", torch.bitwise_not),
               ("isnan", torch.isnan), ("isinf", torch.isinf),
               ("isfinite", torch.isfinite), ("isposinf", torch.isposinf),
               ("isneginf", torch.isneginf), ("isreal", torch.isreal)):
    _unary(_n, _f)
del _n, _f


@register_op("equal_all", amp=False)
def equal_all(x, y, name=None):
    if tuple(x.shape) != tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return torch.all(torch.eq(x, y))


@register_op("bitwise_left_shift", amp=False)
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(*both(x, y))


@register_op("bitwise_right_shift", amp=False)
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_right_shift(*both(x, y))


@register_op("isclose", amp=False)
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = both(x, y)
    rt = torch.result_type(x, y)
    return torch.isclose(x.to(rt), y.to(rt), rtol, atol, equal_nan)


@register_op("allclose", amp=False)
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.all(isclose.__wrapped__(x, y, rtol, atol, equal_nan))


@register_op("is_empty", amp=False)
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


@register_op("isin", amp=False)
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, assume_unique=assume_unique, invert=invert)
