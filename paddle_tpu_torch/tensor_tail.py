"""The top-level tail: the counterpart of ``paddle_tpu/tensor_tail.py``.

- the in-place ``name_`` forms of ``_INPLACE_BASES`` (each writes its
  result into its first argument: ``ops.registry.make_inplace``);
- the dtype and introspection helpers (``finfo``, ``iinfo``,
  ``is_tensor``, ``rank``, ``broadcast_shape``, ``set_grad_enabled``,
  the device RNG state);
- the small ops of the reference's top level, each a registered op.

Paddle's Tensor methods are not installed on ``torch.Tensor``: each
method form's counterpart is the top-level function.
"""

from __future__ import annotations

import numpy as np
import torch

from .framework import dtype as dtypes
from .framework import random as _random
from .ops.impl._common import both, device_of, inexact, shape_of
from .ops.impl.reduce import edges
from .ops.registry import OP_TABLE, make_inplace, register_op

_INPLACE_BASES = [
    "abs", "acos", "addmm", "atan", "bernoulli", "bitwise_and",
    "bitwise_left_shift", "bitwise_not", "bitwise_or",
    "bitwise_right_shift", "bitwise_xor", "cast", "cos", "cumprod",
    "cumsum", "digamma", "equal", "erf", "expm1", "floor_divide", "frac",
    "gammainc", "gammaincc", "gammaln", "gcd", "greater_equal",
    "greater_than", "hypot", "i0", "lcm", "ldexp", "less_equal",
    "less_than", "lgamma", "log", "log10", "log2", "logical_and",
    "logical_not", "logical_or", "logit", "masked_scatter",
    "multigammaln", "nan_to_num", "neg", "polygamma", "pow", "renorm",
    "scatter", "sin", "sinc", "sinh", "square", "t", "tan", "transpose",
    "trunc", "where",
]

# ---- dtype and introspection ----------------------------------------------

float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2
dtype = torch.dtype      # noqa: A001 — paddle.dtype is the dtype type


def finfo(dt):
    return torch.finfo(dtypes.convert_dtype(dt))


def iinfo(dt):
    return torch.iinfo(dtypes.convert_dtype(dt))


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def _dtype_of(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    return dtypes.convert_dtype(np.asarray(x).dtype)


def is_floating_point(x):
    return _dtype_of(x).is_floating_point


def is_integer(x):
    return dtypes.is_integer(_dtype_of(x))


def is_complex(x):
    return _dtype_of(x).is_complex


def rank(x):
    """The number of dims of x, as a 0-dim int64 tensor."""
    nd = x.dim() if isinstance(x, torch.Tensor) else np.asarray(x).ndim
    return torch.tensor(nd, dtype=torch.int64)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def set_grad_enabled(mode):
    """Turn gradient recording on or off; a context manager too."""
    return torch.set_grad_enabled(bool(mode))


def disable_signal_handler():
    pass    # the port installs no signal handlers


def get_cuda_rng_state():
    """The default generators' states ({device: state}, in a list)."""
    return [_random.get_rng_state()]


def set_cuda_rng_state(state):
    if state:
        _random.set_rng_state(state[0])


def check_shape(tensor, expect_shape):
    got = list(tensor.shape)
    ok = len(got) == len(expect_shape) and all(
        e in (-1, None) or g == e for g, e in zip(got, expect_shape))
    if not ok:
        raise ValueError(f"shape mismatch: got {got}, expect "
                         f"{list(expect_shape)}")
    return True


# ---- the small ops --------------------------------------------------------

@register_op("block_diag")
def block_diag(inputs, name=None):
    mats = [torch.atleast_2d(m) for m in inputs]
    return torch.block_diag(*[m.to(mats[0].dtype) for m in mats])


@register_op("cartesian_prod")
def cartesian_prod(x, name=None):
    grids = torch.meshgrid(*x, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], -1)


@register_op("combinations")
def combinations(x, r=2, with_replacement=False, name=None):
    return torch.combinations(x, r, with_replacement)


@register_op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@register_op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.cumulative_trapezoid(y, x, dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)


@register_op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


@register_op("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@register_op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    out = x.clone()
    idx = [slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sd)
    out[tuple(idx)] = value.to(x.dtype)
    return out


@register_op("frexp")
def frexp(x, name=None):
    """(mantissa in [0.5, 1), int32 exponent); the mantissa's gradient is
    2^-exponent."""
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@register_op("gammainc")
def gammainc(x, y, name=None):
    """The regularized lower incomplete gamma P(x, y)."""
    x, y = both(x, y)
    x, y = inexact(x), inexact(y)
    rt = torch.result_type(x, y)
    return torch.special.gammainc(x.to(rt), y.to(rt))


@register_op("multigammaln")
def multigammaln(x, p, name=None):
    return torch.special.multigammaln(inexact(x), int(p))


@register_op("histogram_bin_edges")
def histogram_bin_edges(input, bins=100, min=0, max=0,  # noqa: A002
                        name=None):
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = input.min(), input.max()
    return edges(lo, hi, bins, input).to(torch.float32)


@register_op("pdist")
def pdist(x, p=2.0, name=None):
    n = x.shape[0]
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return torch.linalg.vector_norm(x[iu[0]] - x[iu[1]], ord=p, dim=-1)


@register_op("signbit")
def signbit(x, name=None):
    return torch.signbit(x)


@register_op("vander")
def vander(x, n=None, increasing=False, name=None):
    out = torch.linalg.vander(x, N=n)
    return out if increasing else torch.flip(out, (-1,))


@register_op("unflatten")
def unflatten(x, axis, shape, name=None):
    return torch.unflatten(x, axis, shape_of(shape))


@register_op("take")
def take(x, index, mode="raise", name=None):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, -n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


@register_op("log_normal")
def log_normal(mean=1.0, std=2.0, shape=(1,), name=None, *, device=None):
    dev = device_of(device)
    z = torch.randn(shape_of(shape), generator=_random.default_generator(
        dev), dtype=dtypes.get_default_dtype(), device=dev)
    return torch.exp(mean + std * z)


@register_op("log_normal_")
def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        return x.log_normal_(mean, std,
                             generator=_random.default_generator(x.device))


@register_op("cauchy_")
def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale,
                         generator=_random.default_generator(x.device))


@register_op("geometric_")
def geometric_(x, probs=0.5, name=None):
    with torch.no_grad():
        return x.geometric_(probs,
                            generator=_random.default_generator(x.device))


@register_op("reduce_as")
def reduce_as(x, target, name=None):
    tshape = tuple(target.shape)
    off = x.dim() - len(tshape)
    dims = [i for i in range(x.dim())
            if i < off or x.shape[i] != tshape[i - off]]
    out = torch.sum(x, dims, keepdim=True) if dims else x
    return out.reshape(tshape)


# ---- the split family and other plain helpers -------------------------------

def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(torch.tensor_split(x, num_or_indices, dim=axis))


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.dim() > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def atleast_2d(*inputs, name=None):
    outs = [torch.atleast_2d(t) for t in inputs]
    return outs if len(outs) > 1 else outs[0]


def atleast_3d(*inputs, name=None):
    outs = [torch.atleast_3d(t) for t in inputs]
    return outs if len(outs) > 1 else outs[0]


def floor_mod(x, y, name=None):
    return OP_TABLE["remainder"]["api"](x, y)


def tolist(x):
    return x.tolist() if isinstance(x, torch.Tensor) else \
        np.asarray(x).tolist()


class CUDAPinnedPlace:
    """Page-locked host memory (``Tensor.pin_memory`` holds it)."""

    def __repr__(self):
        return "CUDAPinnedPlace"


class LazyGuard:
    """A scope marker: the port builds parameters where the layers ask."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """The legacy reader decorator: lists of `batch_size` items."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


_PLAIN = ("float8_e4m3fn", "float8_e5m2", "dtype", "finfo", "iinfo",
          "is_tensor", "is_floating_point", "is_integer", "is_complex",
          "rank", "broadcast_shape", "set_printoptions", "set_grad_enabled",
          "disable_signal_handler", "get_cuda_rng_state",
          "set_cuda_rng_state", "check_shape", "tensor_split", "hsplit",
          "vsplit", "dsplit", "atleast_2d", "atleast_3d", "floor_mod",
          "tolist", "CUDAPinnedPlace", "LazyGuard", "batch", "flops")


def flops(net, input_size, custom_ops=None, print_detail=False):
    """What the JAX package's ``flops`` returns
    (``paddle_tpu/tensor_tail.py:514-518``): ``hapi.summary``'s
    ``"total_ops"``, which summary does not count, so 0."""
    from .hapi import summary
    info = summary(net, input_size)
    return info.get("total_ops", 0) if isinstance(info, dict) else 0


def install(ns):
    """Put the ``_INPLACE_BASES`` forms and the helpers into the
    namespace dict `ns` (after the registered ops)."""
    for base in _INPLACE_BASES:
        if base + "_" not in ns and base in OP_TABLE:
            ns[base + "_"] = make_inplace(base, OP_TABLE[base]["api"])
    for nm in _PLAIN:
        ns.setdefault(nm, globals()[nm])
    ns.setdefault("floor_mod_", ns["remainder_"])
