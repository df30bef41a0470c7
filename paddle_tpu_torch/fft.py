"""``paddle.fft``: the counterpart of ``paddle_tpu/fft.py``, on
``torch.fft`` (cuFFT on the card). Each transform is a registered op
under the JAX package's name; ``fftfreq`` / ``rfftfreq`` are plain
functions, in float64 (the JAX package's ``jnp`` default) unless a dtype
is given."""

from __future__ import annotations

import torch

from .framework import dtype as dtypes
from .ops.impl._common import device_of
from .ops.registry import register_op


def _one(name, fn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return fn(x, n=n, dim=axis, norm=norm)
    op.__name__ = op.__qualname__ = name
    globals()[name] = register_op(name)(op)


def _many(name, fn, default_axes):
    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        return fn(x, s=s, dim=None if axes is None else tuple(axes),
                  norm=norm)
    op.__name__ = op.__qualname__ = name
    globals()[name] = register_op(name)(op)


for _n, _f in (("fft", torch.fft.fft), ("ifft", torch.fft.ifft),
               ("rfft", torch.fft.rfft), ("irfft", torch.fft.irfft),
               ("hfft", torch.fft.hfft), ("ihfft", torch.fft.ihfft)):
    _one(_n, _f)
for _n, _f, _a in (("fft2", torch.fft.fft2, (-2, -1)),
                   ("ifft2", torch.fft.ifft2, (-2, -1)),
                   ("rfft2", torch.fft.rfft2, (-2, -1)),
                   ("irfft2", torch.fft.irfft2, (-2, -1)),
                   ("fftn", torch.fft.fftn, None),
                   ("ifftn", torch.fft.ifftn, None),
                   ("rfftn", torch.fft.rfftn, None),
                   ("irfftn", torch.fft.irfftn, None)):
    _many(_n, _f, _a)
del _n, _f, _a


@register_op("fftshift")
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=axes)


@register_op("ifftshift")
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=axes)


def _freq(fn, n, d, dtype, device):
    return fn(int(n), d, dtype=dtypes.convert_dtype(dtype) or torch.float64,
              device=device_of(device))


def fftfreq(n, d=1.0, dtype=None, name=None, *, device=None):
    return _freq(torch.fft.fftfreq, n, d, dtype, device)


def rfftfreq(n, d=1.0, dtype=None, name=None, *, device=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype, device)


__all__ = ["fft", "fft2", "fftfreq", "fftn", "fftshift", "hfft", "ifft",
           "ifft2", "ifftn", "ifftshift", "ihfft", "irfft", "irfft2",
           "irfftn", "rfft", "rfft2", "rfftfreq", "rfftn"]
