"""The activations the port's layers call by name: ``gelu`` (exact unless
approximate, as JAX's ``F.gelu``), ``relu`` and ``tanh``. The others of
``nn.functional`` are the op surface's (``ops.impl.activation``)."""

from __future__ import annotations

import torch

from ...amp import amp_cast


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) by default as JAX's ``F.gelu``; approximate=True
    takes the tanh form (``jax.nn.gelu``'s own default)."""
    x = amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    return torch.relu(amp_cast("relu", x))


def tanh(x, name=None):
    return torch.tanh(amp_cast("tanh", x))


