"""Weights for the port's models: the bridge from ``paddle_tpu``
parameters and seeded random weights.

The port keeps the JAX package's parameter names and layouts (Linear
weights ``[in, out]``), so the bridge is a name-for-name copy with no
transposes: ``from_paddle_tpu_state`` takes the JAX model's parameters as
numpy arrays under its names (``llama.layers.0.self_attn.q_proj.weight``,
...) and copies them into the port's model.
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
    parameters. The names and shapes must match exactly; values are cast
    to the model's dtype (bit-equal when the dtypes agree)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            src = _to_tensor(arrays[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def to_numpy_state(model):
    """{parameter name: np.ndarray} of `model` (bfloat16 as float32)."""
    out = {}
    for name, p in model.named_parameters():
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
