"""The layer base and the basic layers, in paddle's layout: the
counterparts of ``paddle_tpu/nn/layer/layers.py`` (``ParamAttr`` :23,
``Layer`` :69) and of ``paddle_tpu.nn.Linear`` (weight ``[in, out]``,
product ``x @ W``, ``paddle_tpu/nn/layer/common.py:16-34``),
``Embedding``, ``Dropout`` (``common.py:64``), ``RMSNorm``
(``paddle_tpu/nn/layer/norm.py:149``), ``LayerNorm`` (``:121``) and the
activation layers ``GELU``, ``ReLU`` and ``Tanh``.

``Layer`` is a ``torch.nn.Module`` subclass that carries paddle's API:
``create_parameter`` (a ``ParamAttr``'s initializer, else the layer's
default, else Xavier-normal, or zeros for a bias), ``register_buffer``
with ``persistable=``, ``named_sublayers`` / ``sublayers``,
``set_state_dict`` (numpy arrays or tensors; returns (missing,
unexpected)), ``register_forward_post_hook``, ``clear_gradients``,
``astype``, ``add_sublayer`` / ``add_parameter`` and ``full_name``;
``train()`` and ``eval()`` set the mode of the layer and of every
sublayer, in JAX as in torch. A ``ParamAttr``'s ``learning_rate``,
``regularizer``, ``need_clip`` and ``trainable`` land on the parameter
(``optimize_attr``, ``regularizer``, ``need_clip``, ``trainable`` and
``requires_grad``), where the port's optimizers and clips read them; its
``name`` becomes the parameter's ``param_name``.

Each constructor takes the JAX layer's parameters in order, with its
names and defaults; ``name`` is ignored. A layer with parameters takes
``device=`` and ``dtype=`` keyword-only after them; ``device=None`` means
the current device (``device.resolve_device``: the CUDA card unless the
CPU was asked for; it raises without a card), so a CPU layer is asked for
with ``device="cpu"``. Layers without parameters (dropout, the
activations) run on their input's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..framework import dtype as dtypes
from . import functional as F
from . import initializer as I


class ParamAttr:
    """How a layer makes one parameter: name, initializer, learning-rate
    multiplier, regularizer, trainable and need_clip."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None or True -> a default ParamAttr; False stays False (no
        parameter); a str names it; an Initializer initializes it."""
        if attr is None or attr is True:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


def make_parameter(shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None, device=None):
    """A parameter of `shape` made as `attr` says, or None when `attr` is
    False. The initializer is the attr's, else `default_initializer`,
    else zeros for a bias and Xavier-normal for a weight (the JAX
    ``create_parameter``). The device is resolved first, so a layer
    asked for the card raises without one even when it makes no
    parameter."""
    device = resolve_device(device)
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    dtype = dtypes.convert_dtype(dtype) or torch.get_default_dtype()
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    val = init._generate(tuple(int(s) for s in shape), dtype, device)
    p = nn.Parameter(val, requires_grad=bool(attr.trainable))
    p.trainable = bool(attr.trainable)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    if attr.name:
        p.param_name = attr.name
    return p


class Layer(nn.Module):
    """The base of the port's layers (see the module docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction --------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        return make_parameter(shape, attr, dtype or self._dtype, is_bias,
                              default_initializer, device)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """A buffer; a non-persistable one stays out of the state dict
        (``persistent=``, torch's name, is taken too)."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    # -- traversal -----------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) of every sublayer, depth first, each once."""
        memo = layers_set if layers_set is not None else set()
        for name, layer in self.named_modules(memo=memo, prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -- state ---------------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict` ({name: numpy array or tensor}) into the
        layer's parameters and persistable buffers, cast to each one's
        type. A shape that differs raises. Returns (missing,
        unexpected)."""
        own = self.state_dict(keep_vars=True)
        matched, unexpected = set(), []
        with torch.no_grad():
            for name, value in state_dict.items():
                if name not in own:
                    unexpected.append(name)
                    continue
                target = own[name]
                v = value if isinstance(value, torch.Tensor) else \
                    torch.from_numpy(np.array(value, order="C"))
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: loaded "
                        f"{tuple(v.shape)} vs {tuple(target.shape)}")
                target.copy_(v.to(dtype=target.dtype, device=target.device))
                matched.add(name)
        missing = [k for k in own if k not in matched]
        return missing, unexpected

    load_dict = set_state_dict

    # -- hooks, gradients, types ---------------------------------------------
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) after each forward; a value it
        returns replaces the outputs. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    clear_grad = clear_gradients

    def astype(self, dtype):
        """Cast the floating parameters and buffers to `dtype` (a paddle
        name or a torch dtype)."""
        d = dtypes.convert_dtype(dtype)
        self.to(dtype=d)
        for m in self.modules():
            if isinstance(m, Layer):
                m._dtype = d
        return self

    def full_name(self):
        return self._name_scope


class Linear(Layer):
    """y = x @ weight (+ bias); weight [in_features, out_features]
    (Xavier-normal), bias [out_features] (zeros) unless bias_attr is
    False."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal(), device=device)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
            f"out_features={self.out_features}"


class Embedding(Layer):
    """Row gather from weight [num_embeddings, embedding_dim] (N(0, 1)).
    With padding_idx, positions holding it read their row with no
    gradient to it (``F.embedding``); the row itself is zeroed when the
    layer is made, as JAX makes it (a weight loaded later keeps its
    values). sparse is taken and ignored, as in JAX."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), device=device)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class RMSNorm(Layer):
    """RMSNorm over the last dim through ``F.rms_norm``; weight ones, or
    none when weight_attr is False."""

    NORM_SCALES = ("weight",)       # drawn as ones by ``weights``

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class LayerNorm(Layer):
    """LayerNorm over the trailing `normalized_shape` dims through
    ``F.layer_norm``; weight ones and bias zeros, each dropped when its
    ``*_attr`` is False."""

    NORM_SCALES = ("weight",)

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class Dropout(Layer):
    """``F.dropout`` with the layer's p, axis and mode, active in training
    mode only (the JAX layer's); the mask draws from the input device's
    default generator (``framework.random``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class GELU(Layer):
    """``F.gelu``: exact (erf) unless approximate is True (tanh)."""

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)
