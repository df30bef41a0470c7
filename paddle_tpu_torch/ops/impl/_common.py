"""Helpers the op bodies share: shapes, dtypes, devices and the JAX
package's type promotion.

The JAX package's tests (and its CPU runs) enable ``jax_enable_x64``
(``paddle_tpu/__init__.py:27-28``), and the port returns the result types
the JAX package gives there:

- a Python scalar of a higher kind than the tensor it meets (a float with
  an integer or bool tensor, an int with a bool tensor, a complex with a
  real tensor) gives that kind's 64-bit type (``lift``); otherwise the
  tensor's type stands, as torch's own rule has it;
- a floating function of an integer or bool tensor (``sqrt``, ``mean``,
  ``divide``) computes in float64 for int64 and float32 for the narrower
  types (``inexact``), JAX's ``to_inexact_dtype``.

Tensor-with-tensor promotion is torch's, which agrees with JAX's for the
types the port supports.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ...device import resolve_device
from ...framework import dtype as dtypes

_SCALARS = (bool, int, float, complex, np.generic)
_SMALL_FLOATS = (torch.float16, torch.bfloat16, torch.float32)


def is_scalar(v):
    return isinstance(v, _SCALARS) and not isinstance(v, torch.Tensor)


def _kind_of(dt):
    if dt == torch.bool:
        return 0
    if dt.is_complex:
        return 3
    if dt.is_floating_point:
        return 2
    return 1


def _scalar_kind(v):
    if isinstance(v, (bool, np.bool_)):
        return 0
    if isinstance(v, numbers.Integral):
        return 1
    if isinstance(v, numbers.Real):
        return 2
    return 3


def lift(t, *scalars):
    """Tensor `t` in the type it takes against the Python scalars (see
    the module docstring)."""
    kt = _kind_of(t.dtype)
    ks = max((_scalar_kind(s) for s in scalars if is_scalar(s)),
             default=-1)
    if ks <= kt:
        return t
    if ks == 1:
        return t.to(torch.int64)
    if ks == 2:
        return t.to(torch.float64)
    return t.to(torch.complex64 if t.dtype in _SMALL_FLOATS
                else torch.complex128)


def inexact(t):
    """`t` in the floating type a floating function computes it in."""
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return t
    return t.to(torch.float64 if t.dtype == torch.int64 else torch.float32)


def tensor_like(v, like):
    """`v` (a Python scalar, a list or a numpy array) as a tensor on
    `like`'s device: a scalar in `like`'s type (after ``lift``), an array
    in its own."""
    if isinstance(v, torch.Tensor):
        return v
    if is_scalar(v):
        return torch.tensor(v, dtype=lift(like, v).dtype, device=like.device)
    return as_tensor(v, device=like.device)


def pair(x, y):
    """(x, y) of a binary op, promoted as the JAX package promotes them.
    A Python scalar stays a scalar (torch's weak scalar), with the tensor
    lifted; a list or an array becomes a tensor on the other's device."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and yt:
        return x, y
    if xt:
        return (lift(x, y), y) if is_scalar(y) else (x, tensor_like(y, x))
    if yt:
        return (x, lift(y, x)) if is_scalar(x) else (tensor_like(x, y), y)
    return as_tensor(x), as_tensor(y)


def both(x, y):
    """(x, y) of a binary op as two tensors (for torch functions that
    take no Python scalar)."""
    x, y = pair(x, y)
    if not isinstance(x, torch.Tensor):
        x = tensor_like(x, y)
    if not isinstance(y, torch.Tensor):
        y = tensor_like(y, x)
    return x, y


def shape_of(shape):
    """A shape given as an int, a list or tuple (of ints or 0-dim
    tensors) or a tensor, as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, numbers.Integral):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def num(v):
    """A Python number from a number or a one-element tensor."""
    if isinstance(v, torch.Tensor):
        return v.item()
    if isinstance(v, np.generic):
        return v.item()
    return v


def dt(dtype, default_float=True):
    """The torch dtype of `dtype`; None: the default float type (or int64
    with default_float=False)."""
    d = dtypes.convert_dtype(dtype)
    if d is None:
        return dtypes.get_default_dtype() if default_float else torch.int64
    return d


def device_of(device=None, place=None):
    """Where a new tensor goes: `device` or `place`, else the current
    device (``set_device``)."""
    return resolve_device(device if device is not None else place)


def as_tensor(data, dtype=None, device=None):
    """`data` (a tensor, a numpy array, a list or a scalar) as a tensor,
    by numpy's type rules (a Python float is float64), on `device` (the
    current device by default; a tensor keeps its own)."""
    if isinstance(data, torch.Tensor):
        out = data if device is None else data.to(resolve_device(device))
    else:
        arr = np.asarray(data)
        dev = device_of(device)
        out = torch.as_tensor(arr.copy() if arr.ndim else arr, device=dev)
    return out if dtype is None else out.to(dtypes.convert_dtype(dtype))


def axes(axis):
    """An axis argument (int, list, tuple, tensor or None) as torch takes
    it: None, an int or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        vals = axis.reshape(-1).tolist()
        return int(vals[0]) if axis.dim() == 0 else tuple(int(a)
                                                          for a in vals)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def all_dims(x, axis):
    """`axis` for a reduction: every dim when None."""
    a = axes(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a


def to_host(t):
    """A tensor (or array-like) as a numpy array on the host: the host
    ops of the detection and legacy families read their inputs so."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def device_of_input(t):
    return t.device if isinstance(t, torch.Tensor) else torch.device("cpu")


def from_host(arr, device):
    """A numpy result as a tensor on `device` (a 0-d array stays 0-d)."""
    return torch.from_numpy(np.array(arr, order="C")).to(device)
