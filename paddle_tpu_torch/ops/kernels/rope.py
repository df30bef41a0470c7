"""Rotate-half rotary position embedding: the counterpart of
``paddle_tpu/ops/pallas/norms.py`` (``fused_rope_pallas``, reference
``_rope_xla``, and its backward ``_rope_bwd``).

``fused_rope`` launches the CUDA kernel ``csrc/rope.cu`` for a CUDA tensor
and takes the plain version ``fused_rope_plain`` for a CPU tensor. Both
cast the tables to x's type first and compute in x's type, rounding after
each product and after the sum, so in bfloat16 the two agree bit for bit.
Bound and design: see the note in the CUDA source (memory-bound, one pass).

``FusedRoPE`` is the autograd function: its forward is ``fused_rope`` (the
kernel on the card), its backward the vjp of the rotation in x's type in
plain PyTorch, as ``_rope_bwd`` computes it in XLA. The tables get no
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def fused_rope_plain(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D], broadcast over B and H -> x's
    shape and type."""
    d = x.shape[-1]
    c = cos.to(x.dtype)[None, :, None, :]
    s = sin.to(x.dtype)[None, :, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * c + rot * s


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def fused_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return fused_rope_plain(x, cos, sin)
    _build.require_cuda(x, "fused_rope", x=x, cos=cos, sin=sin)
    if x.dim() != 4:
        raise ValueError(f"fused_rope: x must be [B, S, H, D], got "
                         f"{tuple(x.shape)}")
    b, s, h, d = x.shape
    if cos.shape != (s, d) or sin.shape != (s, d) or d % 2:
        raise ValueError(f"fused_rope: tables {tuple(cos.shape)}/"
                         f"{tuple(sin.shape)} do not fit x {tuple(x.shape)} "
                         "(need [S, D] with D even)")
    if cos.dtype != sin.dtype:
        raise ValueError(f"fused_rope: cos and sin must share one dtype, got "
                         f"{cos.dtype}/{sin.dtype}")
    out = torch.empty_like(x)
    fn = _build.function("rope", "ptt_fused_rope", _ARGS)
    _build.check(fn(_build.ptr(x), _build.ptr(cos), _build.ptr(sin),
                    _build.ptr(out), b * s * h, s, h, d, _build.dtype_code(x),
                    _build.dtype_code(cos), _build.stream(x)), "fused_rope")
    fused_rope.launches += 1
    return out


fused_rope.launches = 0


def fused_rope_bwd_plain(g, cos, sin):
    """The vjp of ``fused_rope_plain`` with respect to x, in g's type:
    g * cos + rot^T(g * sin), where rot^T maps the halves (a, b) to
    (b, -a)."""
    d = g.shape[-1]
    c = cos.to(g.dtype)[None, :, None, :]
    s = sin.to(g.dtype)[None, :, None, :]
    gs = g * s
    return g * c + torch.cat([gs[..., d // 2:], -gs[..., : d // 2]], dim=-1)


class FusedRoPE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return fused_rope(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return fused_rope_bwd_plain(g, cos, sin), None, None
