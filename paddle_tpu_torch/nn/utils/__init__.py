"""``nn.utils``: the counterpart of ``paddle_tpu/nn/utils/__init__.py`` —
``parameters_to_vector`` / ``vector_to_parameters`` (:27-39),
``weight_norm`` (:54) and ``remove_weight_norm`` (:93), ``spectral_norm``
(:114), and the gradient clips ``clip_grad_norm_`` / ``clip_grad_value_``
(``nn``'s, re-exported).

The reparameterizations keep the JAX state-dict names: ``weight_norm``
replaces the parameter ``weight`` by ``weight_v`` (a copy) and
``weight_g`` (the norm over every dim but `dim`, squeezed to
``[w.shape[dim]]``; ``[1]`` for dim=None); ``spectral_norm`` by
``weight_orig`` and the buffer ``weight_u`` (a unit vector drawn from
numpy's RandomState(0), as JAX draws it). The derived weight is not a
parameter: a forward pre-hook recomputes it before each forward, from the
parameters, so that gradients reach them, and sets it as a plain
attribute of the layer. ``spectral_norm``'s power iteration advances
``weight_u`` in training mode only (the same u, v in eval).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import clip_grad_norm_, clip_grad_value_  # noqa: F401


def parameters_to_vector(parameters, name=None):
    """The parameters' values flattened and concatenated (no gradient,
    as in JAX)."""
    return torch.cat([p.detach().reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of `vec` into the parameters, in order."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n


def _norm_except(v, dim):
    """||v|| over every dim but `dim` (keepdim), or over all of it."""
    if dim is None:
        return torch.linalg.vector_norm(v)
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _g_shape(ndim, dim):
    shape = [1] * ndim
    shape[dim] = -1
    return shape


def weight_norm(layer, name="weight", dim=0):
    """weight = g * v / ||v|| (see the module docstring)."""
    w = layer._parameters[name]
    with torch.no_grad():
        g0 = _norm_except(w, dim).reshape(-1 if dim is not None else 1)
    v = torch.nn.Parameter(w.detach().clone())
    g = torch.nn.Parameter(g0.clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_v", v)
    layer.register_parameter(name + "_g", g)
    layer._wn_dim = dim

    def compute(layer_, inputs):
        vv = layer_._parameters[name + "_v"]
        gg = layer_._parameters[name + "_g"]
        gb = gg if dim is None else gg.reshape(_g_shape(vv.dim(), dim))
        object.__setattr__(layer_, name, gb * vv / _norm_except(vv, dim))

    layer._wn_handle = layer.register_forward_pre_hook(compute)
    compute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g and v back into one parameter `name`."""
    v = layer._parameters.pop(name + "_v")
    g = layer._parameters.pop(name + "_g")
    if hasattr(layer, "_wn_handle"):
        layer._wn_handle.remove()
    dim = getattr(layer, "_wn_dim", 0)
    with torch.no_grad():
        gb = g if dim is None else g.reshape(_g_shape(v.dim(), dim))
        w = gb * v / _norm_except(v, dim)
    if name in layer.__dict__:
        object.__delattr__(layer, name)
    layer.register_parameter(name, torch.nn.Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """weight = weight_orig / sigma, sigma = u^T W v from power iteration
    (see the module docstring); dim defaults to 1 for a Linear and the
    transposed convolutions, else 0."""
    if n_power_iterations <= 0:
        raise ValueError("Expected n_power_iterations to be positive, got "
                         f"{n_power_iterations}")
    w = layer._parameters[name]
    if dim is None:
        from ... import nn as _nn
        dim = 1 if isinstance(layer, (_nn.Linear, _nn.Conv1DTranspose,
                                      _nn.Conv2DTranspose,
                                      _nn.Conv3DTranspose)) else 0
    h = w.shape[dim]
    u0 = np.random.RandomState(0).randn(h).astype("float32")
    u0 /= np.linalg.norm(u0) + eps
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(w.device))
    orig = torch.nn.Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", orig)

    def compute(layer_, inputs):
        ww = layer_._parameters[name + "_orig"]
        mat_w = torch.movedim(ww, dim, 0).reshape(h, -1)
        with torch.no_grad():
            mat = mat_w.detach()
            u = layer_._buffers[name + "_u"].to(mat.dtype)
            if layer_.training:
                for _ in range(n_power_iterations):
                    v = mat.T @ u
                    v = v / (torch.linalg.vector_norm(v) + eps)
                    u = mat @ v
                    u = u / (torch.linalg.vector_norm(u) + eps)
                layer_._buffers[name + "_u"] = u
            else:
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
        sigma = (u.reshape(1, -1) @ mat_w) @ v.reshape(-1, 1)
        object.__setattr__(layer_, name,
                           ww / sigma.reshape([1] * ww.dim()))

    layer._sn_handle = layer.register_forward_pre_hook(compute)
    compute(layer, None)
    return layer
