"""Creation ops: the counterpart of ``paddle_tpu/ops/impl/creation.py``.

A new tensor goes to the current device (``device.set_device``; the CUDA
card unless the CPU was asked for), or to the ``device=`` a call names.
Random ops draw from the port's default generator of that device
(``framework.random``, seeded by ``seed``); their numbers differ from
``jax.random``'s for the same seed. ``normal_``, ``exponential_`` and
``uniform_`` fill their tensor in place.
"""

from __future__ import annotations

import torch

from ...framework import dtype as dtypes
from ...framework.random import default_generator
from ..registry import register_op
from ._common import as_tensor, device_of, dt, shape_of
from ._common import num as _num


@register_op("zeros")
def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(shape_of(shape), dtype=dt(dtype),
                       device=device_of(device))


@register_op("ones")
def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(shape_of(shape), dtype=dt(dtype),
                      device=device_of(device))


@register_op("full")
def full(shape, fill_value, dtype=None, name=None, *, device=None):
    fill_value = _num(fill_value)
    if dtype is None:
        # paddle: full of an int defaults to the float type, of a bool to
        # bool
        dtype = "bool" if isinstance(fill_value, bool) else \
            dtypes.get_default_dtype()
    return torch.full(shape_of(shape), fill_value,
                      dtype=dtypes.convert_dtype(dtype),
                      device=device_of(device))


@register_op("empty")
def empty(shape, dtype=None, name=None, *, device=None):
    return zeros.__wrapped__(shape, dtype, device=device)


@register_op("zeros_like")
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


@register_op("ones_like")
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=dtypes.convert_dtype(dtype))


@register_op("full_like")
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _num(fill_value),
                           dtype=dtypes.convert_dtype(dtype))


@register_op("empty_like")
def empty_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


@register_op("arange")
def arange(start=0, end=None, step=1, dtype=None, name=None, *,
           device=None):
    start, end, step = _num(start), _num(end), _num(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = dtypes.get_default_dtype() if any(
            isinstance(v, float) for v in (start, end, step)) else "int64"
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=device_of(device))


@register_op("linspace")
def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    out = torch.linspace(float(_num(start)), float(_num(stop)),
                         int(_num(num)), dtype=torch.float64,
                         device=device_of(device))
    return out.to(dt(dtype))


@register_op("logspace")
def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    exps = torch.linspace(float(_num(start)), float(_num(stop)),
                          int(_num(num)), dtype=torch.float64,
                          device=device_of(device))
    return torch.pow(float(base), exps).to(dt(dtype))


@register_op("eye")
def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    n = int(_num(num_rows))
    m = n if num_columns is None else int(_num(num_columns))
    return torch.eye(n, m, dtype=dt(dtype), device=device_of(device))


@register_op("diag")
def diag(x, offset=0, padding_value=0, name=None):
    out = torch.diag(x, offset)
    if padding_value != 0 and x.dim() == 1:
        mask = torch.ones(x.shape[0], dtype=torch.bool,
                          device=x.device).diag(offset)
        out = torch.where(mask, out, torch.tensor(
            padding_value, dtype=out.dtype, device=out.device))
    return out


@register_op("diagflat")
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@register_op("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(x, offset, dim1, dim2)


@register_op("tril", inplace=True)
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@register_op("triu", inplace=True)
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


@register_op("tril_indices")
def tril_indices(row, col, offset=0, dtype="int64", name=None, *,
                 device=None):
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=device_of(device)).to(
        dtypes.convert_dtype(dtype))


@register_op("triu_indices")
def triu_indices(row, col=None, offset=0, dtype="int64", name=None, *,
                 device=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=device_of(device)).to(
        dtypes.convert_dtype(dtype))


@register_op("meshgrid")
def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return tuple(torch.meshgrid(*args, indexing="ij"))


@register_op("assign")
def assign(x, output=None, name=None):
    return x.clone() if isinstance(x, torch.Tensor) else as_tensor(x)


@register_op("clone")
def clone(x, name=None):
    return x.clone()


@register_op("complex")
def complex(real, imag, name=None):  # noqa: A001
    return torch.complex(real, imag)


@register_op("polar")
def polar(abs, angle, name=None):  # noqa: A002
    return torch.polar(abs, angle)


# ---- random ---------------------------------------------------------------

def _gen(dev, seed=0):
    """The generator a random op draws from on `dev`: the default one, or
    a fresh one seeded with a nonzero `seed` (the ops' seed argument)."""
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        return g
    return default_generator(dev)


@register_op("rand")
def rand(shape, dtype=None, name=None, *, device=None):
    dev = device_of(device)
    return torch.rand(shape_of(shape), generator=_gen(dev), dtype=dt(dtype),
                      device=dev)


@register_op("randn")
def randn(shape, dtype=None, name=None, *, device=None):
    dev = device_of(device)
    return torch.randn(shape_of(shape), generator=_gen(dev),
                       dtype=dt(dtype), device=dev)


@register_op("standard_normal")
def standard_normal(shape, dtype=None, name=None, *, device=None):
    return randn.__wrapped__(shape, dtype, device=device)


@register_op("normal")
def normal(mean=0.0, std=1.0, shape=None, name=None, *, device=None):
    dev = next((v.device for v in (mean, std)
                if isinstance(v, torch.Tensor)), None) or device_of(device)
    z = torch.randn(shape_of(shape) if shape is not None else (),
                    generator=_gen(dev), dtype=dtypes.get_default_dtype(),
                    device=dev)
    return mean + std * z


@register_op("uniform")
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None, *, device=None):
    dev = device_of(device)
    u = torch.rand(shape_of(shape), generator=_gen(dev, seed),
                   dtype=dt(dtype), device=dev)
    return u * (_num(max) - _num(min)) + _num(min)


@register_op("randint")
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            device=None):
    if high is None:
        low, high = 0, low
    dev = device_of(device)
    return torch.randint(int(_num(low)), int(_num(high)), shape_of(shape),
                         generator=_gen(dev), device=dev,
                         dtype=dtypes.convert_dtype(dtype))


@register_op("randint_like")
def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = dtypes.convert_dtype(dtype) or x.dtype
    return torch.randint(int(low), int(high), x.shape,
                         generator=_gen(x.device), device=x.device, dtype=d)


@register_op("randperm")
def randperm(n, dtype="int64", name=None, *, device=None):
    dev = device_of(device)
    return torch.randperm(int(n), generator=_gen(dev), device=dev,
                          dtype=dtypes.convert_dtype(dtype))


@register_op("bernoulli")
def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device))


@register_op("poisson")
def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


@register_op("multinomial")
def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, int(num_samples), replacement,
                             generator=_gen(x.device))


@register_op("normal_")
def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


@register_op("exponential_")
def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


@register_op("uniform_")
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device, seed))
