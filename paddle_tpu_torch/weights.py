"""Weights for the port's models: the bridge from ``paddle_tpu``
parameters and seeded random weights.

The port keeps the JAX package's parameter names and layouts (Linear
weights ``[in, out]``), so the bridge is a name-for-name copy with no
transposes: ``from_paddle_tpu_state`` takes the JAX model's parameters as
numpy arrays under its names (``llama.layers.0.self_attn.q_proj.weight``,
...) and copies them into the port's model. Conv weights are ``[out,
in/groups, *k]`` in both packages (the UNet's, ``unet.conv_in.weight``
..., the vision models'), so they too go across as they are; persistable
buffers the arrays name (a batch norm's ``_mean`` and ``_variance``) are
copied as well, and ``to_numpy_state`` gives them back. The RNN layers' weights keep their ``[gates * hidden, in]`` layout
in both packages (``weight_ih_l0`` ...). A ``PipelineLayer`` names its
parameters by run-function index (``"3.lin.weight"``) in both packages, a
shared layer once, under its first index, so it bridges the same way
(its wrappers, ``PipelineParallel`` and the others, name them alike).
``optimizer_state_numpy`` / ``load_optimizer_state`` carry an optimizer's
state in its ``state_dict`` layout, a ZeRO-sharded one's slices gathered
into whole arrays.

The quantized and MoE layers bridge by name too: ``QuantedLinear`` keeps
its Linear as ``inner`` (``...q_proj.inner.weight``), ``QuantedConv2D``
as ``conv``, ``MoELayer`` its ``w_gate_up``, ``w_down`` and
``gate.gate.weight``, in both packages. An observer's calibration state
is no parameter in either package (a Python float, numpy histograms, a
scale tensor): ``observer_state`` reads it from a model of either
package by sublayer name, and ``load_observer_state`` writes it into a
port model, so a calibrated or QAT-trained model carries over whole.
"""

from __future__ import annotations

import numpy as np
import torch

INIT_STD = 0.02


def _to_tensor(arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bfloat16: same bits
        return torch.from_numpy(
            np.array(arr, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_paddle_tpu_state(arrays, model):
    """Copy `arrays` ({JAX parameter name: np.ndarray}) into `model`'s
    parameters, and into the persistable buffers it names. Every
    parameter must be there and every name must be the model's; shapes
    must match exactly; values are cast to the model's dtype (bit-equal
    when the dtypes agree)."""
    params = dict(model.named_parameters())
    targets = dict(params)
    targets.update({n: b for n, b in model.state_dict(keep_vars=True).items()
                    if n in arrays and n not in params})
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(targets))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in targets.items():
            src = _to_tensor(arrays[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def to_numpy_state(model):
    """{name: np.ndarray} of `model`'s parameters and persistable buffers
    (a batch norm's ``_mean`` and ``_variance``; bfloat16 as float32):
    the arrays the JAX model's ``set_state_dict`` takes, the way back of
    ``from_paddle_tpu_state``."""
    out = {}
    for name, p in model.state_dict(keep_vars=True).items():
        t = p.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _init_kinds(model):
    """{id(parameter): kind} of `model`'s parameters. The kind comes from
    the module that owns the parameter: "ones" for a norm's scale (the
    names in the module's ``NORM_SCALES``: a LayerNorm's or RMSNorm's
    weight, a fused layer's ``ln_scale``...), "zeros" for a bias (``bias``
    or ``*_bias``), and None for everything else, drawn N(0, 0.02) (the
    initializer range of the JAX models' configurations)."""
    kinds = {}
    for mod in model.modules():
        ones = getattr(mod, "NORM_SCALES", ())
        for name, p in mod.named_parameters(recurse=False):
            kinds.setdefault(id(p), "ones" if name in ones else (
                "zeros" if name == "bias" or name.endswith("_bias")
                else None))
    return kinds


def random_state(model, seed):
    """{name: float32 np.ndarray} for every parameter of `model`, drawn
    with numpy from `seed` (device independent: the same arrays load into
    a CPU and a CUDA model). For small models; full-size models use
    ``init_random_``."""
    rng = np.random.default_rng(seed)
    kinds = _init_kinds(model)
    out = {}
    for name, p in model.named_parameters():
        kind = kinds[id(p)]
        if kind is None:
            out[name] = INIT_STD * rng.standard_normal(tuple(p.shape),
                                                       dtype=np.float32)
        else:
            out[name] = (np.ones if kind == "ones" else np.zeros)(
                tuple(p.shape), np.float32)
    return out


def init_random_(model, seed):
    """Fill `model`'s parameters in place on their device from a
    torch.Generator seeded with `seed` (fast at full size; the numbers
    depend on the device type)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    kinds = _init_kinds(model)
    with torch.no_grad():
        for p in model.parameters():
            kind = kinds[id(p)]
            if kind is None:
                p.normal_(0.0, INIT_STD, generator=gen)
            else:
                p.fill_(1.0 if kind == "ones" else 0.0)
    return model


def optimizer_state_numpy(optimizer):
    """{key: np.ndarray} of ``optimizer.state_dict()`` (the JAX layout's
    keys and whole arrays; under ZeRO the owners' slices gathered;
    bfloat16 as float32), "@step" an int; the scheduler's state left
    out."""
    out = {}
    for k, v in optimizer.state_dict().items():
        if k == "LR_Scheduler":
            continue
        if torch.is_tensor(v):
            t = v.detach().cpu()
            v = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        out[k] = v
    return out


def load_optimizer_state(optimizer, arrays):
    """Load {key: array} (``optimizer_state_numpy``'s layout, or the JAX
    optimizer's state under this optimizer's keys) into `optimizer`; a
    ZeRO-sharded optimizer hands each owner its slice."""
    optimizer.set_state_dict({k: (v if isinstance(v, int) else
                                  _to_tensor(v))
                              for k, v in arrays.items()})
    return optimizer


# the attributes that hold an observer's or quanter's calibration state
OBSERVER_STATE = ("_scale", "_hist", "_edges", "_edge")


def _state_value(v):
    """An observer attribute as a Python float or a numpy array (a torch
    tensor or another package's tensor, through ``numpy()``)."""
    if v is None or isinstance(v, (int, float)):
        return v
    if torch.is_tensor(v):
        t = v.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    if hasattr(v, "numpy"):
        return np.array(v.numpy(), copy=True)
    return np.array(v, copy=True)


def _sublayers(model):
    """(name, layer) of `model` and its sublayers: ``named_sublayers`` of
    a paddle layer (either package), ``named_modules`` of a torch module."""
    if hasattr(model, "named_sublayers"):
        return list(model.named_sublayers(include_self=True))
    return list(model.named_modules())


def observer_state(model):
    """{sublayer name: {attribute: value}} of every observer and quanter
    (a sublayer with ``quant_bits``) of `model`, a port or a JAX model
    (``named_sublayers``): the scale (a float or a numpy array), and the
    histogram observers' ``_hist`` with ``_edges`` / ``_edge``."""
    out = {}
    for name, layer in _sublayers(model):
        if not hasattr(layer, "quant_bits"):
            continue
        out[name] = {a: _state_value(getattr(layer, a))
                     for a in OBSERVER_STATE if hasattr(layer, a)}
    return out


def load_observer_state(model, state, device=None):
    """Write ``observer_state``'s dict into the port `model`'s observers
    (by sublayer name; every name must be one). A numpy scale becomes a
    float32 tensor on `device` (default: the model's parameters')."""
    layers = dict(_sublayers(model))
    extra = sorted(set(state) - set(layers))
    if extra:
        raise KeyError(f"no such observers: {extra[:5]}")
    if device is None:
        p = next(model.parameters(), None)
        device = p.device if p is not None else "cpu"
    for name, attrs in state.items():
        layer = layers[name]
        for a, v in attrs.items():
            if a == "_scale" and isinstance(v, np.ndarray):
                v = torch.as_tensor(v, dtype=torch.float32, device=device)
            elif isinstance(v, np.ndarray):
                v = v.copy()
            setattr(layer, a, v)
    return model
