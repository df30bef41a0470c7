"""Bias + dropout + residual + LayerNorm ("bdrln"): the counterpart of
``paddle_tpu/ops/pallas/fused_ffn.py`` (``_bdrln_kernel``,
``bias_dropout_residual_ln_pallas``, the LayerNorm ``_ln_xla`` and the
backward ``_bdrln_bwd``).

``bias_dropout_residual_ln`` launches the CUDA kernel
``csrc/bias_dropout_residual_ln.cu`` for CUDA tensors and takes the plain
version ``bias_dropout_residual_ln_plain`` for CPU tensors. Both compute,
over the last dim h,

    y   = residual + dropout(x + bias)          (float32)
    out = LayerNorm(y) * w + b                  (float32, cast to x's type)

and return (out, y in x's type, keep): keep is the uint8 mask of kept
elements when p > 0, else None (nothing dropped, nothing written). A kept
value is multiplied by 1 / (1 - p), as the TPU kernel does (``_bdrln_xla``
divides instead). The random bits are Philox4x32-10 with key (seed, 0):
the element at flat index e takes word e % 4 of the block at counter
(e // 4, 0), and keep = ((bits >> 8) * 2^-24 >= p), the TPU kernel's rule
on its own bits. ``philox4x32`` computes the same stream in int64 tensor
arithmetic, so the kernel's mask is held bit for bit against the plain
one. (The bits differ from the TPU's ``prng_random_bits`` and from
``jax.random``: tests compare statistics, or feed both sides one mask.)

``bias_dropout_residual_ln_bwd_plain`` is ``_bdrln_bwd``: the vjp of the
LayerNorm recomputed from the saved y in x's type (not the float32 y),
dx = dy * keep / (1 - p), dbias the row sum of dx, in plain PyTorch as the
JAX package computes it in XLA. ``BiasDropoutResidualLN`` is the autograd
function over the two. Bound and design: see the note in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, b):
    """(hi, lo) 32-bit halves of the product of the constant a < 2^32 and
    the int64 tensor b of values < 2^32. The product can exceed 2^63, so
    it is formed from 16-bit limbs."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    t = a_lo * b_lo + ((a_hi * b_lo + a_lo * b_hi) << 16)     # < 2^50
    return (a_hi * b_hi + (t >> 32)) & _M32, t & _M32


def philox4x32(counter, key):
    """Philox4x32-10 of int64 tensors. counter: four tensors (or ints) of
    32-bit words; key: two ints. Returns the four output words as int64
    tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in counter)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def dropout_bits(n, seed, device):
    """The kernel's 32-bit words for flat indices 0..n-1 (int64 [n])."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32((g & _M32, g >> 32, 0, 0), (int(seed) & _M32, 0))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_mask_plain(shape, seed, p, device):
    """bool keep mask of the kernel for a tensor of `shape`."""
    n = 1
    for s in shape:
        n *= int(s)
    u = (dropout_bits(n, seed, device) >> 8).to(torch.float32) * 2.0 ** -24
    return (u >= torch.tensor(p, dtype=torch.float32,
                              device=device)).reshape(shape)


def _inv_keep(p):
    """1 / (1 - p) as the float32 constant the kernel multiplies by."""
    return torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)


def _ln(y, w, b, eps):
    """``_ln_xla``: LayerNorm of y over the last dim in float32, times w
    plus b in float32, cast to y's type."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    return ((yf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(
        y.dtype)


def bias_dropout_residual_ln_plain(x, residual, ln_w, ln_b, bias=None,
                                   eps=1e-5, p=0.0, seed=0):
    """x/residual: [..., h]; ln_w/ln_b/bias: [h] -> (out, y, keep)."""
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float()
    keep = None
    if p > 0.0:
        keep = keep_mask_plain(x.shape, seed, p, x.device)
        xf = xf * keep.float() * _inv_keep(p).to(x.device)
        keep = keep.to(torch.uint8)
    y = residual.float() + xf
    return _ln(y, ln_w, ln_b, eps).to(x.dtype), y.to(x.dtype), keep


_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_uint,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]


def bias_dropout_residual_ln(x, residual, ln_w, ln_b, bias=None, eps=1e-5,
                             p=0.0, seed=0):
    """(out, y, keep) of the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"bias_dropout_residual_ln: p must lie in [0, 1), "
                         f"got {p}")
    if x.device.type == "cpu":
        return bias_dropout_residual_ln_plain(x, residual, ln_w, ln_b, bias,
                                              eps, p, seed)
    params = {"ln_w": ln_w, "ln_b": ln_b}
    if bias is not None:
        params["bias"] = bias
    _build.require_cuda(x, "bias_dropout_residual_ln", x=x,
                        residual=residual, **params)
    h = x.shape[-1]
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(f"bias_dropout_residual_ln: residual "
                         f"{tuple(residual.shape)} {residual.dtype} must "
                         f"match x {tuple(x.shape)} {x.dtype}")
    for name, t in params.items():
        if tuple(t.shape) != (h,) or t.dtype != ln_w.dtype:
            raise ValueError(f"bias_dropout_residual_ln: {name} must be "
                             f"[{h}] of ln_w's dtype {ln_w.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    out = torch.empty_like(x)
    y = torch.empty_like(x)
    keep = torch.empty(x.shape, dtype=torch.uint8, device=x.device) \
        if p > 0.0 else None
    ptrs = [x, residual, out, y, ln_w, ln_b] + \
        ([bias] if bias is not None else []) + \
        ([keep] if keep is not None else [])
    vec = h % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ptrs)
    fn = _build.function("bias_dropout_residual_ln",
                         "ptt_bias_dropout_residual_ln", _ARGS)
    _build.check(fn(_build.ptr(x),
                    None if bias is None else _build.ptr(bias),
                    _build.ptr(residual), _build.ptr(ln_w), _build.ptr(ln_b),
                    _build.ptr(out), _build.ptr(y),
                    None if keep is None else _build.ptr(keep),
                    x.numel() // h, h, float(eps), float(p),
                    float(_inv_keep(p)), int(seed) & 0xFFFFFFFF, int(vec),
                    _build.dtype_code(x), _build.dtype_code(ln_w),
                    _build.stream(x)), "bias_dropout_residual_ln")
    bias_dropout_residual_ln.launches += 1
    return out, y, keep


bias_dropout_residual_ln.launches = 0


def bias_dropout_residual_ln_bwd_plain(y, keep, ln_w, ln_b, g, eps=1e-5,
                                       p=0.0, has_bias=True):
    """``_bdrln_bwd``: (dx, dbias, dresidual, dln_w, dln_b) for the output
    gradient g, from the forward's y (x's type) and keep mask (None when
    p == 0). dbias is None without a bias."""
    with torch.enable_grad():
        yy, ww, bb = (t.detach().requires_grad_() for t in (y, ln_w, ln_b))
        dy, dw, db = torch.autograd.grad(_ln(yy, ww, bb, eps), (yy, ww, bb),
                                         g)
    dx = dy.float()
    if keep is not None:
        dx = dx * keep.float()
    if p > 0.0:
        dx = dx * _inv_keep(p).to(dx.device)
    dx = dx.to(y.dtype)
    dbias = dx.reshape(-1, dx.shape[-1]).float().sum(0).to(y.dtype) \
        if has_bias else None
    return dx, dbias, dy, dw, db


class BiasDropoutResidualLN(torch.autograd.Function):
    """out = LayerNorm(residual + dropout(x + bias)) through
    ``bias_dropout_residual_ln`` (the kernel on the card); the backward is
    ``bias_dropout_residual_ln_bwd_plain`` on the saved y and keep mask
    (the counterpart of ``_bdrln_core``'s custom_vjp). bias may be None."""

    @staticmethod
    def forward(ctx, x, bias, residual, ln_w, ln_b, eps, p, seed):
        out, y, keep = bias_dropout_residual_ln(x, residual, ln_w, ln_b,
                                                bias, eps, p, seed)
        ctx.save_for_backward(y, keep, ln_w, ln_b)
        ctx.eps, ctx.p, ctx.has_bias = eps, p, bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        y, keep, ln_w, ln_b = ctx.saved_tensors
        dx, dbias, dres, dw, db = bias_dropout_residual_ln_bwd_plain(
            y, keep, ln_w, ln_b, g, ctx.eps, ctx.p, ctx.has_bias)
        return dx, dbias, dres, dw, db, None, None, None
