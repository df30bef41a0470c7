"""Pooling layers: the counterparts of ``paddle_tpu/nn/layer/pooling.py``;
each calls its functional with the arguments it was made with."""

from __future__ import annotations

from .. import functional as F
from ..layers import Layer


class _Pool(Layer):
    _FN = None

    def __init__(self, **kw):
        super().__init__()
        self._kw = kw

    def forward(self, x):
        return getattr(F, self._FN)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


class AvgPool1D(_Pool):
    _FN = "avg_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive,
                         ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    _FN = "avg_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class AvgPool3D(_Pool):
    _FN = "avg_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)


class MaxPool1D(_Pool):
    _FN = "max_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    _FN = "max_pool2d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    _FN = "max_pool3d"

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask,
                         ceil_mode=ceil_mode, data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    _FN = "adaptive_avg_pool1d"

    def __init__(self, output_size, name=None):
        super().__init__(output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    _FN = "adaptive_avg_pool2d"

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    _FN = "adaptive_avg_pool3d"

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size=output_size, data_format=data_format)


class AdaptiveMaxPool1D(_Pool):
    _FN = "adaptive_max_pool1d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)


class AdaptiveMaxPool2D(_Pool):
    _FN = "adaptive_max_pool2d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    _FN = "adaptive_max_pool3d"

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size=output_size, return_mask=return_mask)


class LPPool2D(_Pool):
    _FN = "lp_pool2d"

    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(norm_type=norm_type, kernel_size=kernel_size,
                         stride=stride, padding=padding, ceil_mode=ceil_mode,
                         data_format=data_format)


__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "LPPool2D", "MaxPool1D",
           "MaxPool2D", "MaxPool3D"]
