"""The kernels as capturable ops: each entry point that a model reaches
through autograd is a ``torch.library.custom_op`` in the ``ptt``
namespace, with a fake implementation (shapes and types) and its
backward registered.

A capture of the port (``torch.fx.experimental.proxy_tensor.make_fx``,
``torch.export``, the graph compiler in ``compiler``) records each op as
one node, ``torch.ops.ptt.<name>``: the counterpart of the JAX package's
``pallas_call`` and ``pjit[name=fused_*]`` equations. Without the ops a
capture saw only what the ``ctypes`` launch left behind (the output's
allocation) and replayed garbage, and it inlined each autograd
function's forward, which dropped its own backward.

Each op's implementation, on the CPU and on the card, is the wrapper of
its kernel module: the plain version for CPU tensors, the ``ctypes``
launch (or a raise) for CUDA tensors, counted where it launches
(``<wrapper>.launches``) exactly as before. The op handles below keep
the names of the autograd functions they replace (``RMSNorm.apply(x, w,
eps)`` and so on), so every caller and every launch count is unchanged.

The backwards are those of the autograd functions: flash attention's and
RoPE's are kernels too (ops themselves, ``flash_attention_bwd``,
``flashmask_attention_bwd``, ``fused_rope_bwd``, ``fused_rope_qk_bwd``),
the others plain PyTorch, as the JAX package computes them in XLA.

``COSTS`` maps each op to the kernel name and cost function under which
``observability.xla_introspect``'s counter charges it (``_cost``): the
counter's dispatch mode sees the op as one call, and the wrapper inside
runs with the modes popped, so each kernel is charged once.

``nn.functional.fused_linear_cross_entropy`` is an op too, though no
kernel: its forward streams the vocab, and a capture that inlined it
would replay the chunk loop under autograd (a different gradient
program, and the [T, V] products kept alive).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import _cost
from .bias_dropout_residual_ln import (bias_dropout_residual_ln,
                                       bias_dropout_residual_ln_bwd_plain)
from .flash_attention import (flash_attention_bwd, flash_attention_fwd,
                              flashmask_attention_bwd,
                              flashmask_attention_fwd)
from .rms_norm import rms_norm, rms_norm_bwd_plain
from .rope import fused_rope, fused_rope_bwd, fused_rope_qk
from .swiglu import swiglu, swiglu_bwd_plain

NAMESPACE = "ptt"
_DEVICES = ("cpu", "cuda")


def _op(name, fn):
    """Register `fn` (annotated) as ptt::<name> on the CPU and the card."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", fn,
                                   mutates_args=(), device_types=_DEVICES)


def _fresh(t):
    """The op's output contiguous, as the fake implementation says (a
    no-op for the kernels' outputs and the plain versions' own)."""
    return t.contiguous()


def _empty(t, shape=None, dtype=None):
    return t.new_empty(tuple(t.shape) if shape is None else tuple(shape),
                       dtype=t.dtype if dtype is None else dtype)


# -- flash attention ------------------------------------------------------

def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
               scale: Optional[float]) -> tuple[Tensor, Tensor]:
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    return _fresh(out), _fresh(lse)


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
               dout: Tensor, causal: bool,
               scale: Optional[float]) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(_fresh(t) for t in flash_attention_bwd(
        q, k, v, out, lse, dout, causal, scale))


def _flashmask_fwd(q: Tensor, k: Tensor, v: Tensor, start: Tensor,
                   end: Tensor, start2: Optional[Tensor],
                   end2: Optional[Tensor], causal: bool,
                   scale: Optional[float]) -> tuple[Tensor, Tensor]:
    out, lse = flashmask_attention_fwd(q, k, v, start, end, start2, end2,
                                       causal, scale)
    return _fresh(out), _fresh(lse)


def _flashmask_bwd(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                   lse: Tensor, dout: Tensor, start: Tensor, end: Tensor,
                   start2: Optional[Tensor], end2: Optional[Tensor],
                   causal: bool,
                   scale: Optional[float]) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(_fresh(t) for t in flashmask_attention_bwd(
        q, k, v, out, lse, dout, start, end, start2, end2, causal, scale))


flash_attention_fwd_op = _op("flash_attention_fwd", _flash_fwd)
flash_attention_bwd_op = _op("flash_attention_bwd", _flash_bwd)
flashmask_attention_fwd_op = _op("flashmask_attention_fwd", _flashmask_fwd)
flashmask_attention_bwd_op = _op("flashmask_attention_bwd", _flashmask_bwd)


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, s, h, _ = q.shape
    return _empty(q), _empty(q, (b, h, s), torch.float32)


@flashmask_attention_fwd_op.register_fake
def _(q, k, v, start, end, start2, end2, causal, scale):
    b, s, h, _ = q.shape
    return _empty(q), _empty(q, (b, h, s), torch.float32)


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, scale):
    return _empty(q), _empty(k), _empty(v)


@flashmask_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, start, end, start2, end2, causal, scale):
    return _empty(q), _empty(k), _empty(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mark_non_differentiable(lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse,
                                        dout.contiguous(), ctx.causal,
                                        ctx.scale)
    return dq, dk, dv, None, None


def _flashmask_setup(ctx, inputs, output):
    q, k, v, start, end, start2, end2, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, start, end, start2, end2)
    ctx.mark_non_differentiable(lse)
    ctx.causal, ctx.scale = causal, scale


def _flashmask_backward(ctx, dout, _dlse):
    q, k, v, out, lse, start, end, start2, end2 = ctx.saved_tensors
    dq, dk, dv = flashmask_attention_bwd_op(
        q, k, v, out, lse, dout.contiguous(), start, end, start2, end2,
        ctx.causal, ctx.scale)
    return dq, dk, dv, None, None, None, None, None, None


flash_attention_fwd_op.register_autograd(_flash_backward,
                                         setup_context=_flash_setup)
flashmask_attention_fwd_op.register_autograd(_flashmask_backward,
                                             setup_context=_flashmask_setup)


# -- RMSNorm and SwiGLU ------------------------------------------------------

def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return _fresh(rms_norm(x, w, eps))


def _swiglu(gate: Tensor, up: Tensor) -> Tensor:
    return _fresh(swiglu(gate, up))


rms_norm_op = _op("rms_norm", _rms)
swiglu_op = _op("swiglu", _swiglu)


@rms_norm_op.register_fake
def _(x, w, eps):
    return _empty(x)


@swiglu_op.register_fake
def _(gate, up):
    return _empty(gate)


def _rms_setup(ctx, inputs, output):
    x, w, eps = inputs
    ctx.save_for_backward(x, w)
    ctx.eps = eps


def _rms_backward(ctx, g):
    x, w = ctx.saved_tensors
    dx, dw = rms_norm_bwd_plain(x, w, g, ctx.eps)
    return dx, dw, None


def _swiglu_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _swiglu_backward(ctx, g):
    gate, up = ctx.saved_tensors
    return swiglu_bwd_plain(gate, up, g)


rms_norm_op.register_autograd(_rms_backward, setup_context=_rms_setup)
swiglu_op.register_autograd(_swiglu_backward, setup_context=_swiglu_setup)


# -- RoPE -------------------------------------------------------------------

def _rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    return _fresh(fused_rope(x, cos, sin))


def _rope_qk(q: Tensor, k: Tensor, cos: Tensor,
             sin: Tensor) -> tuple[Tensor, Tensor]:
    oq, ok = fused_rope_qk(q, k, cos, sin)
    return _fresh(oq), _fresh(ok)


def _rope_bwd(g: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    return _fresh(fused_rope_bwd(g, cos, sin))


def _rope_qk_bwd(gq: Tensor, gk: Tensor, cos: Tensor,
                 sin: Tensor) -> tuple[Tensor, Tensor]:
    dq, dk = fused_rope_bwd(gq, cos, sin, gk)
    return _fresh(dq), _fresh(dk)


fused_rope_op = _op("fused_rope", _rope)
fused_rope_qk_op = _op("fused_rope_qk", _rope_qk)
fused_rope_bwd_op = _op("fused_rope_bwd", _rope_bwd)
fused_rope_qk_bwd_op = _op("fused_rope_qk_bwd", _rope_qk_bwd)


@fused_rope_op.register_fake
def _(x, cos, sin):
    return _empty(x)


@fused_rope_bwd_op.register_fake
def _(g, cos, sin):
    return _empty(g)


@fused_rope_qk_op.register_fake
def _(q, k, cos, sin):
    return _empty(q), _empty(k)


@fused_rope_qk_bwd_op.register_fake
def _(gq, gk, cos, sin):
    return _empty(gq), _empty(gk)


def _rope_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[-2], inputs[-1])


def _rope_backward(ctx, g):
    cos, sin = ctx.saved_tensors
    return fused_rope_bwd_op(g.contiguous(), cos, sin), None, None


def _rope_qk_backward(ctx, gq, gk):
    cos, sin = ctx.saved_tensors
    dq, dk = fused_rope_qk_bwd_op(gq.contiguous(), gk.contiguous(), cos, sin)
    return dq, dk, None, None


fused_rope_op.register_autograd(_rope_backward, setup_context=_rope_setup)
fused_rope_qk_op.register_autograd(_rope_qk_backward,
                                   setup_context=_rope_setup)


# -- bias + dropout + residual + LayerNorm ------------------------------------

def _bdrln(x: Tensor, residual: Tensor, ln_w: Tensor, ln_b: Tensor,
           bias: Optional[Tensor], eps: float, p: float,
           seed: int) -> tuple[Tensor, Tensor, Tensor]:
    out, y, keep = bias_dropout_residual_ln(x, residual, ln_w, ln_b, bias,
                                            eps, p, seed)
    if keep is None:            # p == 0: nothing dropped, no mask
        keep = x.new_empty((0,), dtype=torch.uint8)
    return _fresh(out), _fresh(y), keep


bias_dropout_residual_ln_op = _op("bias_dropout_residual_ln", _bdrln)


@bias_dropout_residual_ln_op.register_fake
def _(x, residual, ln_w, ln_b, bias, eps, p, seed):
    keep = (0,) if p == 0.0 else tuple(x.shape)
    return _empty(x), _empty(x), _empty(x, keep, torch.uint8)


def _bdrln_setup(ctx, inputs, output):
    x, residual, ln_w, ln_b, bias, eps, p, seed = inputs
    out, y, keep = output
    ctx.save_for_backward(y, keep, ln_w, ln_b)
    ctx.mark_non_differentiable(y, keep)
    ctx.eps, ctx.p, ctx.has_bias = eps, p, bias is not None


def _bdrln_backward(ctx, g, _dy, _dkeep):
    y, keep, ln_w, ln_b = ctx.saved_tensors
    dx, dbias, dres, dw, db = bias_dropout_residual_ln_bwd_plain(
        y, keep if keep.numel() else None, ln_w, ln_b, g, ctx.eps, ctx.p,
        ctx.has_bias)
    return dx, dres, dw, db, dbias, None, None, None


bias_dropout_residual_ln_op.register_autograd(_bdrln_backward,
                                              setup_context=_bdrln_setup)


# -- the op handles: the replaced autograd functions' names and calls ---------

class FlashAttention:
    """out = attention(q, k, v) through ``ptt::flash_attention_fwd``
    (``flash_attention_fwd``); the backward is
    ``ptt::flash_attention_bwd`` on the saved q, k, v, out and lse (the
    counterpart of ``_flash_core``'s custom_vjp)."""

    @staticmethod
    def apply(q, k, v, causal, scale):
        return flash_attention_fwd_op(q, k, v, bool(causal), scale)[0]


class FlashmaskAttention:
    """(out, lse) = flashmask attention through
    ``ptt::flashmask_attention_fwd``; the backward is
    ``ptt::flashmask_attention_bwd`` (the counterpart of
    ``_flashmask_core``'s custom_vjp). The bounds get no gradient and lse
    is non-differentiable. start2/end2 may be None."""

    @staticmethod
    def apply(q, k, v, start, end, start2, end2, causal, scale):
        return flashmask_attention_fwd_op(q, k, v, start, end, start2, end2,
                                          bool(causal), scale)


class RMSNorm:
    """``rms_norm`` through ``ptt::rms_norm``; the backward is
    ``rms_norm_bwd_plain`` (``_rms_bwd``)."""

    @staticmethod
    def apply(x, w, eps):
        return rms_norm_op(x, w, float(eps))


class SwiGLU:
    """``swiglu`` through ``ptt::swiglu``; the backward is
    ``swiglu_bwd_plain`` (``_swiglu_bwd``)."""

    @staticmethod
    def apply(gate, up):
        return swiglu_op(gate, up)


class FusedRoPE:
    """``fused_rope`` through ``ptt::fused_rope``; the backward is the
    kernel's transposed form (``ptt::fused_rope_bwd``). The tables get no
    gradient."""

    @staticmethod
    def apply(x, cos, sin):
        return fused_rope_op(x, cos, sin)


class FusedRoPEQK:
    """q and k through one launch each way (``ptt::fused_rope_qk`` and
    ``ptt::fused_rope_qk_bwd``; [S, D] tables when there is a gradient to
    take; the per-token rows serve inference only)."""

    @staticmethod
    def apply(q, k, cos, sin):
        return fused_rope_qk_op(q, k, cos, sin)


class BiasDropoutResidualLN:
    """out = LayerNorm(residual + dropout(x + bias)) through
    ``ptt::bias_dropout_residual_ln``; the backward is
    ``bias_dropout_residual_ln_bwd_plain`` on the saved y and keep mask
    (the counterpart of ``_bdrln_core``'s custom_vjp). bias may be
    None."""

    @staticmethod
    def apply(x, bias, residual, ln_w, ln_b, eps, p, seed):
        return bias_dropout_residual_ln_op(x, residual, ln_w, ln_b, bias,
                                           float(eps), float(p),
                                           int(seed))[0]


def _rope_qk_bwd_cost(gq, gk, cos, sin):
    return _cost.rope_bwd(gq, cos, sin, gk)


# the op a dispatch mode sees -> (the kernel name it is charged under, its
# cost from the op's arguments); the wrapper signatures and the ops' agree
COSTS = {op._opoverload: spec for op, spec in (
    (flash_attention_fwd_op, ("flash_attention", _cost.flash_fwd)),
    (flash_attention_bwd_op, ("flash_attention_bwd", _cost.flash_bwd)),
    (flashmask_attention_fwd_op, ("flashmask_attention",
                                  _cost.flashmask_fwd)),
    (flashmask_attention_bwd_op, ("flashmask_attention_bwd",
                                  _cost.flashmask_bwd)),
    (rms_norm_op, ("rms_norm", _cost.rms_norm)),
    (swiglu_op, ("swiglu", _cost.swiglu)),
    (fused_rope_op, ("fused_rope", _cost.rope)),
    (fused_rope_qk_op, ("fused_rope", _cost.rope_qk)),
    (fused_rope_bwd_op, ("fused_rope_bwd", _cost.rope_bwd)),
    (fused_rope_qk_bwd_op, ("fused_rope_bwd", _rope_qk_bwd_cost)),
    (bias_dropout_residual_ln_op, ("bias_dropout_residual_ln",
                                   _cost.bdrln)))}
