"""The dtype surface: the counterpart of ``paddle_tpu/framework/dtype.py``.

Paddle's dtype names are torch dtypes here (``float32`` IS
``torch.float32``). Strings (``"float32"``, ``"fp16"``, ``"bool"``),
numpy dtypes and torch dtypes all convert through ``convert_dtype``.

The default floating type (``set_default_dtype`` / ``get_default_dtype``,
float32 unless set) is the port's own: creation ops read it. It never
calls ``torch.set_default_dtype``, which would change torch for every
library in the process.
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    # paddle's historical names
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
    "float": float32, "double": float64, "half": float16, "int": int32,
    "long": int64,
}
_FLOATS = (float16, bfloat16, float32, float64)

_default_dtype = [float32]


def convert_dtype(dtype):
    """A Paddle dtype name, a numpy dtype (or type) or a torch dtype as a
    torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        dtype = np.dtype(dtype)
    name = np.dtype(dtype).name
    if name == "bool":
        return bool_
    if name not in _ALIASES:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _ALIASES[name]


def set_default_dtype(d):
    """Set the floating type creation ops give a tensor when no dtype is
    asked for (float16, bfloat16, float32 or float64)."""
    d = convert_dtype(d)
    if d not in _FLOATS:
        raise TypeError(
            f"set_default_dtype only supports float dtypes, got {d}")
    _default_dtype[0] = d


def get_default_dtype():
    return _default_dtype[0]


def is_floating(dtype) -> bool:
    """Floating or complex (the JAX package's rule)."""
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == bool_)


__all__ = ["bfloat16", "bool_", "complex128", "complex64",
           "convert_dtype", "float16", "float32", "float64",
           "get_default_dtype", "int16", "int32", "int64", "int8",
           "is_floating", "is_integer", "set_default_dtype", "uint8"]
