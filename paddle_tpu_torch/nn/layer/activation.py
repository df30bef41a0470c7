"""Activation layers: the counterparts of
``paddle_tpu/nn/layer/activation.py``. Each calls the functional of its
name with the arguments it was made with (positional ones in the
functional's order after x), as the JAX layers do; ``PReLU`` holds its
weight (``init``, 0.25 by default)."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layers import GELU, Layer, ReLU, Tanh


def _make(fname, cls_name):
    class _Act(Layer):
        def __init__(self, *args, **kw):
            super().__init__()
            kw.pop("name", None)
            self._args = args
            self._kw = kw

        def forward(self, x):
            return getattr(F, fname)(x, *self._args, **self._kw)

    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    _Act.__doc__ = f"``F.{fname}`` as a layer."
    return _Act


ReLU6 = _make("relu6", "ReLU6")
Sigmoid = _make("sigmoid", "Sigmoid")
Silu = _make("silu", "Silu")
Swish = _make("swish", "Swish")
Hardswish = _make("hardswish", "Hardswish")
Hardsigmoid = _make("hardsigmoid", "Hardsigmoid")
Hardtanh = _make("hardtanh", "Hardtanh")
Hardshrink = _make("hardshrink", "Hardshrink")
Softshrink = _make("softshrink", "Softshrink")
Tanhshrink = _make("tanhshrink", "Tanhshrink")
ThresholdedReLU = _make("thresholded_relu", "ThresholdedReLU")
LeakyReLU = _make("leaky_relu", "LeakyReLU")
ELU = _make("elu", "ELU")
SELU = _make("selu", "SELU")
CELU = _make("celu", "CELU")
Mish = _make("mish", "Mish")
Softplus = _make("softplus", "Softplus")
Softsign = _make("softsign", "Softsign")
LogSigmoid = _make("log_sigmoid", "LogSigmoid")
Softmax = _make("softmax", "Softmax")
LogSoftmax = _make("log_softmax", "LogSoftmax")
GLU = _make("glu", "GLU")
Maxout = _make("maxout", "Maxout")
RReLU = _make("rrelu", "RReLU")


class PReLU(Layer):
    """max(0, x) + weight * min(0, x), weight [num_parameters] per channel
    (or one)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]
