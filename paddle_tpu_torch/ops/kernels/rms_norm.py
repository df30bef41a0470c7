"""Row RMSNorm: the counterpart of ``paddle_tpu/ops/pallas/norms.py``
(``_rms_kernel`` / ``_rms_xla``, ``rms_norm_pallas``, and its backward
``_rms_bwd``).

``rms_norm`` launches the CUDA kernel ``csrc/rms_norm.cu`` for a CUDA
tensor and takes the plain version ``rms_norm_plain`` for a CPU tensor.
Both compute in float32, multiply by the weight in float32 and cast once
to the input's type. Bound and design: see the note in the CUDA source
(memory-bound; each row read once in 16-byte vectors and held in
registers, the weight loaded once per thread; a scalar path for widths
that are no whole number of vectors).

``RMSNorm`` (``_ops``, the op ``ptt::rms_norm``) is the differentiable
form: its forward is ``rms_norm`` (the kernel on the card), its backward
``rms_norm_bwd_plain``, the vjp of ``_rms_xla`` in plain PyTorch, as the
JAX package computes it in XLA outside Pallas.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _cost


def rms_norm_plain(x, w, eps=1e-6):
    """x: [..., H]; w: [H] -> x's shape and type."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


@_cost.costed("rms_norm", _cost.rms_norm)
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


def rms_norm_bwd_plain(x, w, g, eps=1e-6):
    """The vjp of ``rms_norm_plain`` at (x, w) for the output gradient g
    -> (dx in x's type, dw in w's type); float32 throughout."""
    h = x.shape[-1]
    xf, gf, wf = x.float(), g.float(), w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dn = gf * wf                         # gradient of the normalized x
    dw = (gf * (xf * r)).reshape(-1, h).sum(0)
    dx = r * dn - xf * (r * r * r) * (dn * xf).mean(dim=-1, keepdim=True)
    return dx.to(x.dtype), dw.to(w.dtype)
