"""SwiGLU: the counterpart of ``paddle_tpu/ops/pallas/fused_ffn.py``
(``_swiglu_kernel`` / ``_swiglu_xla``, ``swiglu_pallas``, and its
backward ``_swiglu_bwd``).

``swiglu`` launches the CUDA kernel ``csrc/swiglu.cu`` for CUDA tensors
and takes the plain version ``swiglu_plain`` for CPU tensors. Both compute
``gate * sigmoid(gate) * up`` in float32 and cast once to gate's type.
Bound and design: see the note in the CUDA source (memory-bound,
16-byte loads).

``SwiGLU`` is the autograd function: its forward is ``swiglu`` (the kernel
on the card), its backward ``_swiglu_bwd``'s formula in float32, cast to
the input types, in plain PyTorch as the JAX package computes it in XLA.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def swiglu_plain(gate, up):
    """gate/up: [..., F] -> silu(gate) * up in gate's type."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def swiglu(gate, up):
    """gate/up: [..., F], same shape and type. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if gate.device.type == "cpu":
        return swiglu_plain(gate, up)
    _build.require_cuda(gate, "swiglu", gate=gate, up=up)
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(
            f"swiglu: gate {tuple(gate.shape)} {gate.dtype} and up "
            f"{tuple(up.shape)} {up.dtype} must match")
    out = torch.empty_like(gate)
    fn = _build.function("swiglu", "ptt_swiglu", _ARGS)
    _build.check(fn(_build.ptr(gate), _build.ptr(up), _build.ptr(out),
                    gate.numel(), _build.dtype_code(gate),
                    _build.stream(gate)), "swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0


def swiglu_bwd_plain(gate, up, g):
    """``_swiglu_bwd``: (dgate, dup) for the output gradient g, computed in
    float32 and cast to gate's and up's types."""
    gf, gd = gate.float(), g.float()
    sig = torch.sigmoid(gf)
    silu = gf * sig
    dgate = gd * up.float() * (sig + silu * (1.0 - sig))
    dup = gd * silu
    return dgate.to(gate.dtype), dup.to(up.dtype)


class SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu(gate, up)

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        return swiglu_bwd_plain(gate, up, g)
