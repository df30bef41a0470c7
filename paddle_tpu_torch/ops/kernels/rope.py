"""Rotate-half rotary position embedding: the counterpart of
``paddle_tpu/ops/pallas/norms.py`` (``fused_rope_pallas``, reference
``_rope_xla``, and its backward ``_rope_bwd``) and of the Llama's per-token
rotation ``paddle_tpu/models/llama.py: _rope_rows``.

One CUDA kernel, ``csrc/rope.cu``, serves every form in one launch: q alone
(``fused_rope``) or q and k together (``fused_rope_qk``, k with as many or
fewer heads than q), with the ``[S, D]`` tables broadcast over the batch or
with per-token rows (``[B, D]`` for a decode step's one token, ``[B, Q, D]``
for a ragged chunk), forward or transposed (``fused_rope_bwd``, the vjp).
A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
versions ``fused_rope_plain``, ``fused_rope_rows_plain`` and
``fused_rope_bwd_plain``. Both cast the tables to x's type first and
compute in x's type, rounding after each product and after the sum, so in
bfloat16 the two agree bit for bit. Bound and design: see the note in the
CUDA source (memory-bound, one pass).

Launch counts: ``fused_rope.launches`` counts every forward launch of the
kernel, through either wrapper; ``fused_rope_qk.launches`` the q + k ones
among them; ``fused_rope_bwd.launches`` the transposed ones. Each also
counts its launches on the scalar path (``scalar_launches``: a head dim
whose half is no whole number of 16-byte vectors, or unaligned pointers).

``FusedRoPE`` and ``FusedRoPEQK`` (``_ops``, the ops ``ptt::fused_rope``
and ``ptt::fused_rope_qk``) are the differentiable forms: their forward
is ``fused_rope`` / ``fused_rope_qk``, their backward ``fused_rope_bwd``
(one launch for q and k). The tables get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _cost


def fused_rope_plain(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D], broadcast over B and H -> x's
    shape and type."""
    d = x.shape[-1]
    c = cos.to(x.dtype)[None, :, None, :]
    s = sin.to(x.dtype)[None, :, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * c + rot * s


def fused_rope_rows_plain(x, cos, sin):
    """Rotate-half RoPE with per-token positions: x [B, Q, H, D]; cos/sin
    [B, D] (Q = 1 decode) or [B, Q, D] (ragged chunk), the table rows at
    each token's own position."""
    if cos.dim() == 3:
        cos = cos[:, :, None, :].to(x.dtype)
        sin = sin[:, :, None, :].to(x.dtype)
    else:
        cos = cos[:, None, None, :].to(x.dtype)
        sin = sin[:, None, None, :].to(x.dtype)
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def fused_rope_bwd_plain(g, cos, sin):
    """The vjp of ``fused_rope_plain`` with respect to x, in g's type:
    g * cos + rot^T(g * sin), where rot^T maps the halves (a, b) to
    (b, -a)."""
    d = g.shape[-1]
    c = cos.to(g.dtype)[None, :, None, :]
    s = sin.to(g.dtype)[None, :, None, :]
    gs = g * s
    return g * c + torch.cat([gs[..., d // 2:], -gs[..., : d // 2]], dim=-1)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def _check(what, x, cos, sin, k=None, rows=False):
    """Refuse what the kernel does not take, on any device; return the
    table row stride for x [B, S, H, D]: 0 for [S, D] tables; with `rows`,
    also S for per-token rows [B, S, D] and 1 for [B, D] when S = 1."""
    named = {"x": x, "cos": cos, "sin": sin}
    if k is not None:
        named["k"] = k
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be [B, S, H, D], got "
                         f"{tuple(x.shape)}")
    b, s, _, d = x.shape
    if d % 2:
        raise ValueError(f"{what}: the head dim must be even, got {d}")
    if cos.dtype != sin.dtype or cos.shape != sin.shape:
        raise ValueError(f"{what}: cos and sin must share one dtype and "
                         f"shape, got {cos.dtype}{tuple(cos.shape)}/"
                         f"{sin.dtype}{tuple(sin.shape)}")
    if k is not None:
        if k.dtype != x.dtype or k.dim() != 4 or \
                k.shape[:2] != x.shape[:2] or k.shape[3] != d:
            raise ValueError(f"{what}: k {k.dtype}{tuple(k.shape)} must be "
                             f"[B, S, Hk, D] of x's type beside "
                             f"{x.dtype}{tuple(x.shape)}")
        if x.shape[2] % k.shape[2]:
            raise ValueError(f"{what}: k's {k.shape[2]} heads do not divide "
                             f"q's {x.shape[2]}")
    if cos.shape == (s, d):
        return 0
    if rows and cos.shape == (b, s, d):
        return s
    if rows and s == 1 and cos.shape == (b, d):
        return 1
    forms = "[S, D], [B, S, D] or (S = 1) [B, D]" if rows else "[S, D]"
    raise ValueError(f"{what}: tables {tuple(cos.shape)} do not fit x "
                     f"{tuple(x.shape)} (need {forms})")


def _launch(what, q, k, cos, sin, row_stride, transpose):
    """One launch of csrc/rope.cu over q (and k) -> (q's out, k's out or
    None)."""
    b, s, hq, d = q.shape
    oq = torch.empty_like(q)
    ok = None if k is None else torch.empty_like(k)
    null = ctypes.c_void_p(None)
    vec = ctypes.c_int(0)
    fn = _build.function("rope", "ptt_rope", _ARGS)
    _build.check(fn(_build.ptr(q), null if k is None else _build.ptr(k),
                    _build.ptr(oq), null if k is None else _build.ptr(ok),
                    _build.ptr(cos), _build.ptr(sin), b * s, s, hq,
                    0 if k is None else k.shape[2], d, row_stride,
                    int(transpose), _build.dtype_code(q),
                    _build.dtype_code(cos), ctypes.byref(vec),
                    _build.stream(q)), what)
    counter = fused_rope_bwd if transpose else fused_rope
    counter.launches += 1
    counter.scalar_launches += not vec.value
    return oq, ok


@_cost.costed("fused_rope", _cost.rope)
def fused_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    row_stride = _check("fused_rope", x, cos, sin)
    if x.device.type == "cpu":
        return fused_rope_plain(x, cos, sin)
    _build.require_cuda(x, "fused_rope", x=x, cos=cos, sin=sin)
    return _launch("fused_rope", x, None, cos, sin, row_stride, False)[0]


@_cost.costed("fused_rope", _cost.rope_qk)
def fused_rope_qk(q, k, cos, sin):
    """q [B, S, Hq, D] and k [B, S, Hk, D] (Hk dividing Hq) rotated by the
    same tables in one launch -> (q_rot, k_rot). Tables: [S, D], broadcast
    over the batch, or the rows at each token's own position, [B, S, D]
    (a ragged chunk) or [B, D] (a decode step, S = 1). CPU tensors take the
    plain versions; CUDA tensors launch the kernel (or raise)."""
    row_stride = _check("fused_rope_qk", q, cos, sin, k, rows=True)
    if q.device.type == "cpu":
        plain = fused_rope_rows_plain if row_stride else fused_rope_plain
        return plain(q, cos, sin), plain(k, cos, sin)
    _build.require_cuda(q, "fused_rope_qk", q=q, k=k, cos=cos, sin=sin)
    out = _launch("fused_rope_qk", q, k, cos, sin, row_stride, False)
    fused_rope_qk.launches += 1
    return out


@_cost.costed("fused_rope_bwd", _cost.rope_bwd)
def fused_rope_bwd(g, cos, sin, g_k=None):
    """The vjp of ``fused_rope`` with respect to x: g [B, S, H, D] (and,
    for the q + k form, g_k [B, S, Hk, D] in the same launch); cos/sin
    [S, D]. Returns g's gradient, or the pair with g_k's. CPU tensors take
    ``fused_rope_bwd_plain``; CUDA tensors launch the kernel's transposed
    form (or raise)."""
    row_stride = _check("fused_rope_bwd", g, cos, sin, g_k)
    if g.device.type == "cpu":
        out = fused_rope_bwd_plain(g, cos, sin)
        return out if g_k is None else (
            out, fused_rope_bwd_plain(g_k, cos, sin))
    extra = {} if g_k is None else {"g_k": g_k}
    _build.require_cuda(g, "fused_rope_bwd", g=g, cos=cos, sin=sin, **extra)
    out = _launch("fused_rope_bwd", g, g_k, cos, sin, row_stride, True)
    return out[0] if g_k is None else out


fused_rope.launches = fused_rope.scalar_launches = 0
fused_rope_qk.launches = 0
fused_rope_bwd.launches = fused_rope_bwd.scalar_launches = 0
