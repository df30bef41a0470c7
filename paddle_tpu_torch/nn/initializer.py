"""Parameter initializers: the counterpart of
``paddle_tpu/nn/initializer/__init__.py``.

Each initializer makes a tensor of a shape, type and device
(``_generate``) or fills a parameter in place (``init(param)``). The
draws come from an explicit ``torch.Generator``: the device's default
generator of ``framework.random`` (seeded by ``paddle_tpu_torch.seed``),
or the one an initializer holds as its ``generator`` attribute. The
numbers differ from the JAX package's for the same seed; their
distributions are the same.

Fans follow paddle's layouts, as the JAX package computes them
(``_compute_fans``): a 2-D weight is a Linear weight ``[in, out]``, so its
fan-in is dim 0 (``torch.nn.init`` reads dim 1); a conv weight
``[out, in, *k]`` has fan-in ``in * prod(k)``. 16-bit parameters are
drawn in float32 and cast, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..framework import dtype as dtypes
from ..framework.random import default_generator

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "constant", "normal", "set_global_initializer",
           "uniform"]


def _compute_fans(shape):
    """(fan_in, fan_out) of a parameter shape in paddle's layouts."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _compute_dtype(dtype):
    return torch.float32 if dtype.itemsize < 4 else dtype


class Initializer:
    """Base class. ``init(param)`` fills `param` in place (outside
    autograd) and returns it; ``_generate(shape, dtype, device)`` makes a
    new tensor."""

    def __init__(self):
        self.generator = None

    def _with(self, other):
        """This initializer, drawing from `other`'s generator."""
        self.generator = getattr(other, "generator", None)
        return self

    def _gen(self, device):
        gen = getattr(self, "generator", None)
        return gen if gen is not None else default_generator(device)

    def _generate(self, shape, dtype, device=None):
        raise NotImplementedError

    def __call__(self, param, block=None):
        with torch.no_grad():
            param.copy_(self._generate(tuple(param.shape), param.dtype,
                                       param.device))
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def _generate(self, shape, dtype, device=None):
        return torch.full(shape, self.value, dtype=dtype,
                          device=resolve_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device=None):
        dev = resolve_device(device)
        v = torch.randn(shape, generator=self._gen(dev), device=dev,
                        dtype=_compute_dtype(dtype))
        return (self.mean + self.std * v).to(dtype)


class TruncatedNormal(Initializer):
    """N(mean, std) cut to [mean + a std, mean + b std], drawn by the
    inverse CDF of a uniform draw between Phi(a) and Phi(b) (the form
    ``jax.random.truncated_normal`` takes)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        super().__init__()
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _generate(self, shape, dtype, device=None):
        dev = resolve_device(device)
        ct = _compute_dtype(dtype)
        lo = math.erf(self.a / math.sqrt(2.0))
        hi = math.erf(self.b / math.sqrt(2.0))
        u = torch.rand(shape, generator=self._gen(dev), device=dev, dtype=ct)
        v = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        v = v.clamp(self.a, self.b)
        return (self.mean + self.std * v).to(dtype)


def _uniform(gen, shape, dtype, dev, low, high):
    u = torch.rand(shape, generator=gen, device=dev,
                   dtype=_compute_dtype(dtype))
    return (low + (high - low) * u).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        super().__init__()
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device=None):
        dev = resolve_device(device)
        return _uniform(self._gen(dev), shape, dtype, dev, self.low,
                        self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        super().__init__()
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device=None):
        fin, fout = _compute_fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        std = self.gain * math.sqrt(2.0 / (fin + fout))
        return Normal(0.0, std)._with(self)._generate(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        super().__init__()
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device=None):
        fin, fout = _compute_fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        limit = self.gain * math.sqrt(6.0 / (fin + fout))
        dev = resolve_device(device)
        return _uniform(self._gen(dev), shape, dtype, dev, -limit, limit)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        super().__init__()
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device=None):
        fin = self.fan_in or _compute_fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity,
                            self.negative_slope) / math.sqrt(fin)
        return Normal(0.0, std)._with(self)._generate(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        super().__init__()
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device=None):
        fin = self.fan_in or _compute_fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity,
                              self.negative_slope) * math.sqrt(3.0 / fin)
        dev = resolve_device(device)
        return _uniform(self._gen(dev), shape, dtype, dev, -limit, limit)


class Assign(Initializer):
    """The given value (an array, a list or a tensor), of the parameter's
    shape."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def _generate(self, shape, dtype, device=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = torch.as_tensor(np.array(v)).to(
            dtype=dtype, device=resolve_device(device))
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {tuple(arr.shape)} "
                             f"!= param shape {tuple(shape)}")
        return arr


class Orthogonal(Initializer):
    """gain * an orthogonal matrix [shape[0], prod(shape[1:])] (the QR of
    a normal draw, signs fixed by R's diagonal)."""

    def __init__(self, gain=1.0):
        super().__init__()
        self.gain = gain

    def _generate(self, shape, dtype, device=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal requires >=2 dims")
        dev = resolve_device(device)
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = torch.randn((max(rows, cols), min(rows, cols)),
                           generator=self._gen(dev), device=dev,
                           dtype=torch.float32)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(shape)).to(dtype)


class Dirac(Initializer):
    """Identity conv kernels: 1 at the spatial center of (out i, in i)
    for each group."""

    def __init__(self, groups=1):
        super().__init__()
        self.groups = groups

    def _generate(self, shape, dtype, device=None):
        out_c, in_c = shape[0], shape[1]
        v = np.zeros(shape, np.float32)
        centers = [s // 2 for s in shape[2:]]
        min_c = min(out_c // self.groups, in_c)
        for g in range(self.groups):
            for i in range(min_c):
                v[(g * (out_c // self.groups) + i, i, *centers)] = 1.0
        return torch.from_numpy(v).to(dtype=dtype,
                                      device=resolve_device(device))


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a conv_transpose weight
    [C_out, C_in, K, K]."""

    def _generate(self, shape, dtype, device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear expects a 4-D conv weight")
        w = np.zeros(shape, np.float32)
        k = shape[-1]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % k
            y = (i // k) % shape[-2]
            w[np.unravel_index(i, shape)] = \
                (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(w).to(
            dtype=dtypes.convert_dtype(dtype) or torch.float32,
            device=resolve_device(device))


# paddle-compatible aliases
constant = Constant
normal = Normal
uniform = Uniform


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Record the global weight and bias initializers. As in the JAX
    package, ``create_parameter`` does not read them: a parameter takes
    its ParamAttr's initializer, else the layer's default."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init
