"""The basic layers of the port's models, in paddle's layout: the
counterparts of ``paddle_tpu.nn.Linear`` (weight ``[in, out]``, product
``x @ W``, ``paddle_tpu/nn/layer/common.py:16-34``), ``Embedding``,
``Dropout`` (``common.py:64``), ``RMSNorm``
(``paddle_tpu/nn/layer/norm.py:149``), ``LayerNorm`` (``:121``) and the
activation layers ``GELU``, ``ReLU`` and ``Tanh``
(``paddle_tpu/nn/layer/activation.py:10-32``). Parameters are trainable
and made empty on the given device (biases zeros, as JAX's bias
initializer makes them); ``paddle_tpu_torch.weights`` fills them. The
serving entry points run under ``torch.inference_mode()``, so serving
builds no autograd graph.

Each constructor takes the JAX layer's parameters in order, with its
names and defaults: a ``*_attr`` of False drops that parameter, None (or
True) keeps it, and a ``ParamAttr`` is not ported (``wants_param``);
``name`` is ignored. A layer with parameters takes ``device=`` and
``dtype=`` keyword-only after them; ``device=None`` means the CUDA card
(``device.resolve_device``: it raises without one), so a CPU layer is
asked for with ``device="cpu"``. Layers without parameters (dropout, the
activations) run on their input's device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..amp import amp_cast
from ..device import resolve_device
from . import functional as F


def wants_param(attr, what):
    """Whether a layer makes the parameter of a JAX-style `attr`: None or
    True yes, False no; a ParamAttr (initializer, name, learning rate) is
    not ported and raises."""
    if attr is None or attr is True:
        return True
    if attr is False:
        return False
    raise NotImplementedError(f"{what}={attr!r}: only None, True or False "
                              "(ParamAttr is not ported)")


class Linear(nn.Module):
    """y = x @ weight (+ bias); weight [in_features, out_features]; a bias
    [out_features] of zeros unless bias_attr is False, as in JAX."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        wants_param(weight_attr, "weight_attr")
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               **kw))
        self.bias = nn.Parameter(torch.zeros(out_features, **kw)) if \
            wants_param(bias_attr, "bias_attr") else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Row gather from weight [num_embeddings, embedding_dim]. With
    padding_idx, positions holding it read their row with no gradient to
    it (``F.embedding`` of JAX); the row itself is zeroed when the layer
    is made, as JAX makes it (a weight loaded later keeps its values).
    sparse is taken and ignored, as in JAX."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        wants_param(weight_attr, "weight_attr")
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, ids):
        out = amp_cast("embedding", self.weight)[ids]
        if self.padding_idx is None:
            return out
        keep = (ids != self.padding_idx)[..., None].to(out.dtype)
        return out * keep + (out * (1 - keep)).detach()


class RMSNorm(nn.Module):
    """RMSNorm over the last dim through ``F.rms_norm``; weight ones, or
    none when weight_attr is False."""

    NORM_SCALES = ("weight",)       # drawn as ones by ``weights``

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=dev, dtype=dtype)) if wants_param(
                weight_attr, "weight_attr") else None

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` dims through
    ``F.layer_norm``; weight ones and bias zeros, each dropped when its
    ``*_attr`` is False."""

    NORM_SCALES = ("weight",)

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(
            self.normalized_shape, **kw)) if wants_param(
                weight_attr, "weight_attr") else None
        self.bias = nn.Parameter(torch.zeros(
            self.normalized_shape, **kw)) if wants_param(
                bias_attr, "bias_attr") else None

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
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


class GELU(nn.Module):
    """``F.gelu``: exact (erf) unless approximate is True (tanh)."""

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)
