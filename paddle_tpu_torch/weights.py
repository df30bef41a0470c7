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


def _init_std(name):
    """Llama's initializer range for matrices; RMSNorm weights are 1."""
    if name.endswith("layernorm.weight") or name == "llama.norm.weight":
        return None
    return 0.02


def random_state(model, seed):
    """{name: float32 np.ndarray} for every parameter of `model`, drawn
    with numpy from `seed` (device independent: the same arrays load into
    a CPU and a CUDA model). For small models; full-size models use
    ``init_random_``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        std = _init_std(name)
        if std is None:
            out[name] = np.ones(tuple(p.shape), np.float32)
        else:
            out[name] = (std * rng.standard_normal(
                tuple(p.shape), dtype=np.float32))
    return out


def init_random_(model, seed):
    """Fill `model`'s parameters in place on their device from a
    torch.Generator seeded with `seed` (fast at full size; the numbers
    depend on the device type)."""
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = _init_std(name)
            if std is None:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)
    return model
