"""Layer containers: the counterparts of ``paddle_tpu.nn.Sequential`` and
``LayerList`` (``paddle_tpu/nn/layer/layers.py:366, :396``). Sublayers are
named ``"0"``, ``"1"``, ... as in JAX, and those names are part of the
parameter names (``gpt.h.0.mlp.2.weight``) that ``weights`` carries across.
"""

from __future__ import annotations

from collections import OrderedDict

from torch import nn


class Sequential(nn.Sequential):
    """Calls its sublayers in order. Takes layers (named "0", "1", ...)
    or one list of (name, layer) pairs, as the JAX container does."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = (OrderedDict(layers[0]),)
        super().__init__(*layers)


class LayerList(nn.ModuleList):
    """A list of sublayers named by their index."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
