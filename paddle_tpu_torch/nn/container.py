"""Layer containers: the counterparts of ``paddle_tpu.nn.Sequential``,
``LayerList`` and ``ParameterList`` (``paddle_tpu/nn/layer/layers.py:366,
:396, :434``). Each is a ``Layer`` and the matching torch container.
Sublayers (and parameters) are named ``"0"``, ``"1"``, ... as in JAX,
and those names are part of the parameter names (``gpt.h.0.mlp.2.weight``)
that ``weights`` carries across.
"""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

from .layers import Layer


class Sequential(Layer, nn.Sequential):
    """Calls its sublayers in order. Takes layers (named "0", "1", ...)
    or one list of (name, layer) pairs, as the JAX container does."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = (OrderedDict(layers[0]),)
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_module(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    """A list of sublayers named by their index."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """A list of parameters named by their index."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            for p in parameters:
                self.append(p)
