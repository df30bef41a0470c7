"""``paddle.save`` / ``paddle.load``: the counterpart of
``paddle_tpu/framework/io.py`` (``save`` :70, ``load`` :78).

The format is the JAX package's (Paddle's ``.pdparams`` / ``.pdopt``
protocol): a pickle of the object with every tensor written as a plain
numpy array, so a file written by either package loads in the other, and
unpickles with neither importable. bfloat16 tensors are written as
``ml_dtypes`` bfloat16 arrays, as the JAX package writes them, when
``ml_dtypes`` is importable, else as float32.

``load`` turns every numpy array back into a tensor on the current
device (``set_device``), with its dtype (the JAX package narrows float64
to float32 when x64 is off; torch keeps float64); ``return_numpy=True``
returns the arrays as they are.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _bf16_numpy(t):
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return _bf16_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return tuple(packed) if isinstance(obj, tuple) else packed
    return obj


def _from_numpy(arr):
    """A CPU tensor holding a copy of `arr` (an ``ml_dtypes`` bfloat16
    array becomes a bfloat16 tensor)."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _to_tensor(arr):
    from ..device import resolve_device
    return _from_numpy(arr).to(resolve_device(None))


def _unpack(obj, return_numpy=False):
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else _to_tensor(obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        unpacked = [_unpack(v, return_numpy) for v in obj]
        return tuple(unpacked) if isinstance(obj, tuple) else unpacked
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (tensors as numpy arrays) to `path`, making its
    directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    """The object `save` wrote (or the JAX package's ``save``), its
    arrays as tensors on the current device (``return_numpy=True``:
    as arrays)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, configs.get("return_numpy", False))
