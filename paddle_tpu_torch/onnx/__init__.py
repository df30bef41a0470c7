"""``paddle.onnx`` in the port: the counterpart of
``paddle_tpu/onnx/__init__.py``.

The reference delegates to the external ``paddle2onnx`` converter, and
neither machine this package runs on has the ``onnx`` package, so no
``.onnx`` protobuf is written. What is exported is the port's deployable
program format, ``torch.export``:

- ``<base>.pt2``: the serialized ``ExportedProgram`` of the layer's eval
  forward (weights inside, each kernel one ``ptt`` op node);
- ``<base>.json``: ``{"format": "torch.export", "inputs": [{"shape",
  "dtype"}], "opset_version_requested"}``;

where ``<base>`` is `path` without a trailing ``.onnx``.
``export_format="onnx"`` raises RuntimeError when the ``onnx`` package is
missing, as the JAX package's does.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _example(spec, device):
    """An example input: a tensor as it is, a numpy array as a tensor, a
    shape-only spec (an InputSpec) as zeros with a dim of None or -1 at 1,
    as the JAX package traces it."""
    from ..framework.dtype import convert_dtype
    from ..framework.io import _from_numpy
    if isinstance(spec, torch.Tensor):
        return spec.detach().to(device)
    if isinstance(spec, np.ndarray):
        return _from_numpy(spec).to(device)
    if hasattr(spec, "shape") and hasattr(spec, "dtype"):
        shape = [1 if d in (None, -1) else int(d) for d in spec.shape]
        return torch.zeros(shape, dtype=convert_dtype(spec.dtype),
                           device=device)
    raise TypeError(f"bad input_spec entry {type(spec).__name__}")


def export(layer, path, input_spec=None, opset_version=9,
           output_spec=None, export_format="torch.export", **configs):
    """Export `layer`'s eval forward as a deployable artifact (see the
    module docstring); returns the ``.pt2`` path.

    input_spec: example tensors / numpy arrays / InputSpecs shaping the
    traced signature (the signature is static)."""
    if export_format == "onnx":
        try:
            import onnx  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "ONNX protobuf emission needs the `onnx` package, which is "
                "not available in this environment. Export defaults to a "
                "torch.export program (export_format='torch.export'), which "
                "torch.onnx can convert offline where onnx is "
                "installed.") from e
    if input_spec is None:
        raise ValueError("onnx.export requires input_spec example inputs")
    from ..jit import _dtype_name, _layer_device, export_layer
    from ..ops.kernels import _ops  # noqa: F401  (the ptt ops)

    device = _layer_device(layer)
    examples = [_example(s, device) for s in input_spec]
    program = export_layer(layer, examples)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    base = path[:-5] if path.endswith(".onnx") else path
    torch.export.save(program, base + ".pt2")
    meta = {
        "format": "torch.export",
        "inputs": [{"shape": list(e.shape), "dtype": _dtype_name(e.dtype)}
                   for e in examples],
        "opset_version_requested": opset_version,
    }
    with open(base + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return base + ".pt2"


def load(path):
    """A ``.pt2`` artifact back as a callable (the program's module, on
    the device it was exported on)."""
    from ..ops.kernels import _ops  # noqa: F401  (the ptt ops)
    return torch.export.load(path).module()
