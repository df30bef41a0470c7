"""paddle strings tensor ops: a copy of ``paddle_tpu/strings.py`` (numpy
only; ref: paddle/phi/ops/yaml/strings_ops.yaml —
empty, empty_like, lower, upper; kernels phi/kernels/strings/,
core phi/core/string_tensor.h).

Strings are host data (the reference's StringTensor lives on CPU pinned
memory too — strings never reach the accelerator); here a StringTensor is
a thin wrapper over a numpy unicode array, which is exactly the role the
reference's pstring buffer plays. Used by tokenizer-style preprocessing
ahead of the device pipeline.
"""

from __future__ import annotations

import numpy as np


class StringTensor:
    """ref: phi/core/string_tensor.h:29 (dims + pstring holder)."""

    def __init__(self, data, name=None):
        self._data = np.asarray(data, dtype=np.str_)
        self.name = name

    @property
    def shape(self):
        return list(self._data.shape)

    def numpy(self):
        return self._data

    def __eq__(self, other):
        o = other._data if isinstance(other, StringTensor) else other
        return bool(np.all(self._data == o))

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, {self._data!r})"


def to_string_tensor(data, name=None):
    return StringTensor(data, name)


def empty(shape, name=None):
    """ref strings_ops.yaml empty: uninitialized string tensor."""
    return StringTensor(np.full(tuple(shape), "", dtype=np.str_))


def empty_like(x, name=None):
    return empty(x.shape if isinstance(x, StringTensor) else
                 np.asarray(x).shape)


def lower(x, use_utf8_encoding=True, name=None):
    """ref strings_ops.yaml lower (kernel strings_lower_upper_kernel)."""
    x = x if isinstance(x, StringTensor) else StringTensor(x)
    return StringTensor(np.char.lower(x._data))


def upper(x, use_utf8_encoding=True, name=None):
    x = x if isinstance(x, StringTensor) else StringTensor(x)
    return StringTensor(np.char.upper(x._data))
