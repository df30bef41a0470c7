"""Row RMSNorm: the counterpart of ``paddle_tpu/ops/pallas/norms.py``
(``_rms_kernel`` / ``_rms_xla``, ``rms_norm_pallas``). Forward only in
this slice; the backward comes with training.

``rms_norm`` launches the CUDA kernel ``csrc/rms_norm.cu`` for a CUDA
tensor and takes the plain version ``rms_norm_plain`` for a CPU tensor.
Both compute in float32, multiply by the weight in float32 and cast once
to the input's type. Bound and design: see the note in the CUDA source
(memory-bound, one block per row).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def rms_norm_plain(x, w, eps=1e-6):
    """x: [..., H]; w: [H] -> x's shape and type."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


def rms_norm(x, w, eps=1e-6):
    """x: [..., H]; w: [H]. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    _build.require_cuda(x, "rms_norm", x=x, w=w)
    h = x.shape[-1]
    if w.shape != (h,):
        raise ValueError(f"rms_norm: weight shape {tuple(w.shape)} != ({h},)")
    out = torch.empty_like(x)
    rows = x.numel() // h if h else 0
    fn = _build.function("rms_norm", "ptt_rms_norm", _ARGS)
    _build.check(fn(_build.ptr(x), _build.ptr(w), _build.ptr(out), rows, h,
                    float(eps), _build.dtype_code(x), _build.dtype_code(w),
                    _build.stream(x)), "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
