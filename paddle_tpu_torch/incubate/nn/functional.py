"""Fused FFN ops: the counterparts of ``paddle_tpu/ops/impl/fused.py``'s
``fused_bias_dropout_residual_layer_norm`` (:117) and ``fused_feedforward``
(:148).

``fused_bias_dropout_residual_layer_norm`` is the bdrln op
(``ops.kernels.BiasDropoutResidualLN``: the CUDA kernel for CUDA tensors,
its plain version on the CPU, for every h; the JAX package takes its TPU
kernel only when h % 128 == 0 and XLA otherwise). Its dropout seed is one
int in [0, 2^31 - 1) drawn per call while training with p > 0, as the JAX
op draws it. ``fused_feedforward`` keeps its two GEMMs as ``torch.matmul``
(the JAX package leaves them to XLA), runs the ``swiglu`` activation
through the SwiGLU kernel and the others in plain PyTorch (the JAX op
takes any ``jax.nn`` activation by name; ``_ACTIVATIONS`` maps the
elementwise ones to their ``torch.nn.functional`` counterparts, ``gelu``
being JAX's default tanh approximation), dropout1 and the pre-norm tail
in plain PyTorch, and the post-norm tail through the bdrln op. Both take
the JAX op's parameters in order (``name`` ignored); ``generator=`` is
keyword-only after them.
"""

from __future__ import annotations

import torch

from ...framework.random import next_seed
from ...nn import functional as F
from ...ops import kernels as _k
from ...ops.kernels.bias_dropout_residual_ln import _ln

_F = torch.nn.functional
# jax.nn name -> the same function in torch (jax.nn's defaults: gelu
# approximate=True, leaky_relu slope 0.01, elu/celu alpha 1)
_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": _F.relu6,
    "gelu": lambda t: _F.gelu(t, approximate="tanh"),
    "silu": _F.silu,
    "swish": _F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": _F.elu,
    "selu": _F.selu,
    "celu": _F.celu,
    "leaky_relu": _F.leaky_relu,
    "softplus": _F.softplus,
    "soft_sign": _F.softsign,
    "log_sigmoid": _F.logsigmoid,
    "hard_sigmoid": _F.hardsigmoid,
    "hard_silu": _F.hardswish,
    "hard_swish": _F.hardswish,
    "hard_tanh": _F.hardtanh,
    "mish": _F.mish,
}


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, name=None, *,
                                           generator=None):
    """out = LayerNorm(residual + dropout(x + bias)) * ln_scale + ln_bias
    over the last dim, in one kernel. ln_scale/ln_bias default to ones and
    zeros; bias, ln_scale and ln_bias share one dtype. generator draws the
    dropout seed (default: the CPU generator of ``framework.random``)."""
    h = x.shape[-1]
    if ln_scale is None:
        ln_scale = torch.ones(h, dtype=x.dtype, device=x.device)
    if ln_bias is None:
        ln_bias = torch.zeros(h, dtype=x.dtype, device=x.device)
    p = float(dropout_rate) if training else 0.0
    seed = next_seed(generator) if p > 0.0 else 0
    return _k.BiasDropoutResidualLN.apply(x, bias, residual, ln_scale,
                                          ln_bias, ln_epsilon, p, seed)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu", ln_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None, *,
                      generator=None):
    """The transformer FFN block:

        residual = x
        out = LN1(x) if pre_layer_norm else x
        out = dropout1(act(out @ linear1_weight + linear1_bias))
        out = out @ linear2_weight
        out = residual + dropout2(out + linear2_bias)   # then LN2 post-norm

    Weights [in, out]; "swiglu" splits the first product's output in two
    halves (gate, up). generator (on x's device; default: the device's
    generator, and the CPU's for the bdrln seed) draws the dropout masks
    and the bdrln op's seed."""
    h = x.shape[-1]
    residual = x
    out = x
    if pre_layer_norm:
        s = ln1_scale if ln1_scale is not None else torch.ones(
            h, dtype=x.dtype, device=x.device)
        b = ln1_bias if ln1_bias is not None else torch.zeros(
            h, dtype=x.dtype, device=x.device)
        out = _ln(out, s, b, ln_epsilon)
    out = F.linear(out, linear1_weight, linear1_bias)
    if activation == "swiglu":
        gate, up = out.chunk(2, dim=-1)
        out = F.swiglu(gate.contiguous(), up.contiguous())
    elif activation in _ACTIVATIONS:
        out = _ACTIVATIONS[activation](out)
    else:
        raise ValueError(f"fused_feedforward: activation {activation!r} is "
                         f"not one of {sorted(_ACTIVATIONS) + ['swiglu']}")
    p1 = float(dropout1_rate) if training else 0.0
    if p1 > 0.0:
        out = F.dropout(out, p1, training=True, generator=generator)
    out = torch.matmul(out, linear2_weight)
    if pre_layer_norm:
        p2 = float(dropout2_rate) if training else 0.0
        if linear2_bias is not None:
            out = out + linear2_bias
        if p2 > 0.0:
            out = F.dropout(out, p2, training=True, generator=generator)
        return residual + out
    return fused_bias_dropout_residual_layer_norm(
        out, residual, bias=linear2_bias, ln_scale=ln2_scale,
        ln_bias=ln2_bias, dropout_rate=dropout2_rate, ln_epsilon=ln_epsilon,
        training=training, generator=generator)
