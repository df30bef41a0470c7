"""The fused layer of the FFN epilogue: the counterpart of
``paddle_tpu/incubate/nn/layer.py:57 FusedBiasDropoutResidualLayerNorm``.
Its parameters keep the JAX names (``linear_bias``, ``ln_scale``,
``ln_bias``), so ``weights.from_paddle_tpu_state`` carries them across, and
its constructor the JAX parameters in order (``bias_attr`` False drops
linear_bias and ``weight_attr`` False ln_scale, as in JAX; ``name``
ignored),
``device=`` and ``dtype=`` keyword-only after them.
"""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.layers import wants_param
from . import functional as F


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """out = LayerNorm(residual + dropout(x + linear_bias)) * ln_scale +
    ln_bias, through the bdrln op; dropout only in training mode. The
    parameters live on `device` (default: the CUDA card)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = nn.Parameter(torch.zeros(embed_dim, **kw)) if \
            wants_param(bias_attr, "bias_attr") else None
        self.ln_scale = nn.Parameter(torch.ones(embed_dim, **kw)) if \
            wants_param(weight_attr, "weight_attr") else None
        self.ln_bias = nn.Parameter(torch.zeros(embed_dim, **kw))

    def forward(self, x, residual, generator=None):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias,
            dropout_rate=self.dropout_rate if self.training else 0.0,
            ln_epsilon=self.epsilon, generator=generator)
