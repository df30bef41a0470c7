"""Conv layers: the counterparts of ``paddle_tpu/nn/layer/conv.py``.
Weights ``[out, in/groups, *k]`` (a transpose: ``[in, out/groups, *k]``)
drawn KaimingUniform(negative_slope=sqrt(5)) over the weight's fans, the
bias uniform in +-1/sqrt(in/groups * prod(k)), as in JAX."""

from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..layers import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0,
                 device=None, dtype=None):
        super().__init__()
        k = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * ndim
        self._ndim = ndim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = k
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._transpose = transpose
        shape = ([in_channels, out_channels // groups] if transpose else
                 [out_channels, in_channels // groups]) + k
        bound = 1.0 / math.sqrt(in_channels // groups * math.prod(k))
        self.weight = self.create_parameter(
            shape, attr=weight_attr, dtype=dtype,
            default_initializer=I.KaimingUniform(
                negative_slope=math.sqrt(5), nonlinearity="leaky_relu"),
            device=device)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, dtype=dtype, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), device=device)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class _ConvTransposeNd(_ConvNd):
    _FN = None

    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride, padding, output_padding, groups, dilation,
                 weight_attr, bias_attr, data_format, device, dtype):
        super().__init__(in_channels, out_channels, kernel_size, ndim,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         dtype=dtype)

    def forward(self, x, output_size=None):
        return type(self)._FN(x, self.weight, self.bias, self.stride,
                              self.padding, self.output_padding, self.groups,
                              self.dilation, output_size, self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)


class Conv2DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)


class Conv3DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device, dtype)


__all__ = ["Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose"]
