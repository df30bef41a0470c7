"""The layers the Llama model uses, in paddle's layout: the counterparts
of ``paddle_tpu.nn.Linear`` (weight ``[in, out]``, product ``x @ W``,
``paddle_tpu/nn/layer/common.py:16-34``), ``Embedding``, ``RMSNorm``
(``paddle_tpu/nn/layer/norm.py:149``) and ``LayerNorm`` (``:121``). Parameters are trainable and made
empty on the given device (biases zeros, as JAX's bias initializer makes
them); ``paddle_tpu_torch.weights`` fills them. The serving entry points
run under ``torch.inference_mode()``, so serving builds no autograd graph.

Each constructor takes the JAX layer's parameters in order, with its
names and defaults: a ``*_attr`` of False drops that parameter, None (or
True) keeps it, and a ``ParamAttr`` is not ported (``wants_param``);
``name`` is ignored. ``device=`` and ``dtype=`` are keyword-only after
them.
"""

from __future__ import annotations

import torch
from torch import nn

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
        wants_param(weight_attr, "weight_attr")
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if wants_param(
                bias_attr, "bias_attr") else None

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


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
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, ids):
        out = self.weight[ids]
        if self.padding_idx is None:
            return out
        keep = (ids != self.padding_idx)[..., None].to(out.dtype)
        return out * keep + (out * (1 - keep)).detach()


class RMSNorm(nn.Module):
    """RMSNorm over the last dim through ``F.rms_norm``; weight ones, or
    none when weight_attr is False."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=device, dtype=dtype)) if wants_param(
                weight_attr, "weight_attr") else None

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` dims through
    ``F.layer_norm``; weight ones and bias zeros, each dropped when its
    ``*_attr`` is False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(
            self.normalized_shape, **kw)) if wants_param(
                weight_attr, "weight_attr") else None
        self.bias = nn.Parameter(torch.zeros(
            self.normalized_shape, **kw)) if wants_param(
                bias_attr, "bias_attr") else None

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
