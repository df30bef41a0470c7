"""The layers the Llama model uses, in paddle's layout: the counterparts
of ``paddle_tpu.nn.Linear`` (weight ``[in, out]``, product ``x @ W``,
``paddle_tpu/nn/layer/common.py:16-34``), ``Embedding``, ``RMSNorm``
(``paddle_tpu/nn/layer/norm.py:149``) and ``LayerNorm`` (``:121``). Parameters are trainable and made
empty on the given device; ``paddle_tpu_torch.weights`` fills them. The
serving entry points run under ``torch.inference_mode()``, so serving
builds no autograd graph.
"""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F


class Linear(nn.Module):
    """y = x @ weight (+ bias); weight [in_features, out_features]."""

    def __init__(self, in_features, out_features, bias=False, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Row gather from weight [num_embeddings, embedding_dim]."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return self.weight[ids]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing `normalized_shape` dims through
    ``F.layer_norm``; weight ones and bias zeros, each dropped when its
    ``*_attr`` is False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        kw = {"device": device, "dtype": dtype}
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(self.normalized_shape, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
