"""Flash attention, forward and backward: the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd_bhsd`` /
``_fwd_kernel``, ``flash_attention_fwd``, reference
``_sdpa_reference_gqa``; the backward ``_flash_bwd_bhsd`` with
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` and the glue ``_flash_core_fwd``
/ ``_flash_core_bwd``) and of ``paddle_tpu/ops/primitive/lowering_gpu.py``
(``_flash_fwd_gpu``), which computes the same forward.

``flash_attention_fwd`` launches a CUDA kernel for CUDA tensors and takes
the plain version ``flash_attention_fwd_plain`` for CPU tensors. Both take
paddle's layout, mask causally with bottom-right alignment, read K/V heads
by index under GQA, accumulate in float32, and return ``(out, lse)``: out
in q's type, lse ``[B, H, S_q]`` float32 (the TPU kernel's lane-broadcast
lse layout is dropped).

``flash_attention_bwd`` and ``flash_attention_bwd_plain`` give (dq, dk,
dv) from q, k, v, the forward's out and lse, and the output's gradient;
dk/dv are already summed over each KV head's group of query heads.

Two routes, chosen by type and head dim (``route``), never by failure:
bfloat16 and float16 inputs with D in {64, 128} launch the tensor-core
kernels ``csrc/flash_fwd_sm90.cu`` / ``csrc/flash_bwd_sm90.cu`` (wgmma on
TMA-staged tiles; P and dS rounded to the input type before the PV, dV,
dK and dQ products, as the TPU kernel does); float32, and any other head
dim (D % 8 == 0 up to 256), launch the float32 SIMT kernels
``csrc/flash_attention.cu`` / ``csrc/flash_attention_bwd.cu`` (P and dS
kept float32). A route's kernel that fails to build or launch raises. Each
wrapper counts its launches in ``launches`` and per route in
``sm90_launches`` / ``simt_launches``. The plain versions keep P and dS in
float32 by default; ``p_dtype`` rounds them where the TPU kernel does.

``FlashAttention`` is the autograd function that pairs the two: its
forward is the forward kernel and it saves q, k, v, out and the float32
lse. Bound and design: see the notes in the CUDA sources.

Flashmask (``flashmask_attention_fwd`` / ``_bwd`` and their ``_plain``
versions; ``_flashmask_core``, ``_expand_mask_heads`` and
``flashmask_attention_fwd`` of the JAX module) is the same pair of kernels
with a range mask: bounds [B, kh, S_k] int32 (kh 1, H_kv or H, read by the
kernels per query head, never expanded), one or two intervals of query
rows per key that cannot see it, [start[t], end[t]) and [start2[t],
end2[t]), on top of the causal and length tests. Its launches are counted
apart from the unmasked ones. A row that sees no key writes 0 and lse =
NEG_INF + log(L_EPS) (-1e30 in float32; the JAX package's dense path gives
the logsumexp of its -1e30 logits there instead, so such rows' lse are not
compared). ``FlashmaskAttention`` is its autograd function: the bounds get
no gradient and lse comes out detached, as JAX's stop_gradient has it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import NEG_INF

L_EPS = 1e-30          # the finalize's clamp of the normalizer
MAX_HEAD_DIM = 256     # head dims the CUDA kernel takes: D % 8 == 0, <= this


def _causal_mask(s_q, s_k, device):
    """[S_q, S_k] bool: query i sees key t when i + (S_k - S_q) >= t."""
    return torch.ones(s_q, s_k, dtype=torch.bool, device=device).tril(
        s_k - s_q)


def _visible(b, s_q, s_k, h_kv, rep, causal, bounds, device):
    """bool [B or 1, H_kv, rep or 1, S_q, S_k] of the (query, key) pairs
    that attend, or None when every pair does. bounds: None or (start,
    end, start2, end2) of [B, kh, S_k] (start2/end2 may be None)."""
    vis = _causal_mask(s_q, s_k, device) if causal else None
    if bounds is None:
        return vis
    start, end, start2, end2 = bounds
    rows = torch.arange(s_q, device=device)[:, None]

    def heads(m):       # [B, kh, S_k] -> [B, kh or H_kv, 1 or rep, 1, S_k]
        if m.shape[1] == h_kv * rep and rep > 1:
            return m.reshape(b, h_kv, rep, 1, s_k)
        return m[:, :, None, None, :]

    masked = (heads(start) <= rows) & (rows < heads(end))
    if start2 is not None:
        masked = masked | ((heads(start2) <= rows) & (rows < heads(end2)))
    return ~masked if vis is None else ~masked & vis


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None,
                              bounds=None, *, p_dtype=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> (out [B, S_q, H, D] in
    q's type, lse [B, H, S_q] float32). bounds: the flashmask operands
    (start, end, start2, end2), or None.

    Scores, softmax and the PV product run in float32. By default P stays
    float32 for the PV product, as in ``_flash_fwd_gpu`` and the SIMT
    kernel. With ``p_dtype`` (the tensor-core kernel's rounding, and the TPU
    kernel's: ``tiles.online_softmax_update(p_dtype=v.dtype)``) the
    normalizer l sums float32 P and P is then rounded to p_dtype before the
    PV product, which still sums in float32. A row with no visible key
    writes 0 and lse = NEG_INF + log(L_EPS), the finalize's clamp, as the
    kernels do."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s_q, h_kv, rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    vis = _visible(b, s_q, s_k, h_kv, rep, causal, bounds, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = p * vis          # rows with no visible key: exp(0) -> 0
    lc = p.sum(dim=-1, keepdim=True).clamp_min(L_EPS)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    out = acc / lc.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(lc))[..., 0].reshape(b, h, s_q)
    return out.reshape(b, s_q, h, d).to(q.dtype), lse


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

SM90_DTYPES = (torch.bfloat16, torch.float16)
SM90_HEAD_DIMS = (64, 128)
# (direction, masked, route) -> (csrc source, C entry)
ENTRIES = {
    ("fwd", False, "sm90"): ("flash_fwd_sm90", "ptt_flash_attention_fwd_sm90"),
    ("fwd", True, "sm90"): ("flash_fwd_sm90",
                            "ptt_flashmask_attention_fwd_sm90"),
    ("bwd", False, "sm90"): ("flash_bwd_sm90", "ptt_flash_attention_bwd_sm90"),
    ("bwd", True, "sm90"): ("flash_bwd_sm90",
                            "ptt_flashmask_attention_bwd_sm90"),
    ("fwd", False, "simt"): ("flash_attention", "ptt_flash_attention_fwd"),
    ("fwd", True, "simt"): ("flash_attention", "ptt_flashmask_attention_fwd"),
    ("bwd", False, "simt"): ("flash_attention_bwd",
                             "ptt_flash_attention_bwd"),
    ("bwd", True, "simt"): ("flash_attention_bwd",
                            "ptt_flashmask_attention_bwd"),
}


def route(q):
    """The kernel route of a launch on q: "sm90" (tensor cores) for
    bfloat16/float16 with head dim 64 or 128, else "simt" (float32 CUDA
    cores). A stated routing by type and shape: the float32 checks hold
    the SIMT kernels to 1e-4, which TF32 tensor-core products would break,
    and no path of the port has another head dim in 16 bits."""
    if q.dtype in SM90_DTYPES and q.shape[-1] in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


def entry(direction, masked, q):
    """(csrc source, C entry) that a launch on q takes."""
    return ENTRIES[(direction, bool(masked), route(q))]


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (TMA
    tensor maps need 16-byte aligned bases; a contiguous view into a larger
    buffer may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(wrapper, rt):
    wrapper.launches += 1
    setattr(wrapper, f"{rt}_launches", getattr(wrapper, f"{rt}_launches") + 1)


def _check(q, k, v, what="flash_attention_fwd"):
    _build.require_cuda(q, what, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[B, S, H, D] with k and v alike")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         "heads not a multiple of the KV heads)")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the CUDA kernel takes head "
                         f"dims that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{what}: q, k and v must share one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")


_MASK_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2


def _check_bounds(q, k, bounds, what):
    """Raise unless bounds are (start, end, start2, end2) int32 tensors of
    one shape [B, kh, S_k] with kh 1, H_kv or H (start2/end2 both None or
    both given). Returns (pointer arguments, kh, intervals)."""
    start, end, start2, end2 = bounds
    if (start2 is None) != (end2 is None):
        raise ValueError(f"{what}: start2 and end2 must be given together")
    given = {"start": start, "end": end}
    if start2 is not None:
        given.update(start2=start2, end2=end2)
    _build.require_cuda(q, what, **given)
    b, _, h, _ = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    kh = start.shape[1] if start.dim() == 3 else -1
    for name, t in given.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (b, kh, s_k) or \
                kh not in (1, h_kv, h):
            raise ValueError(f"{what}: {name} must be int32 [B, kh, S_k] = "
                             f"[{b}, 1|{h_kv}|{h}, {s_k}] like start, got "
                             f"{tuple(t.shape)} {t.dtype}")
    ptrs = [_build.ptr(t) for t in (start, end)] + (
        [_build.ptr(start2), _build.ptr(end2)] if start2 is not None
        else [None, None])
    return ptrs + [kh, 2 if start2 is not None else 1]


def _fwd(q, k, v, causal, scale, bounds, what):
    """Launch the forward kernel of q's route (masked when bounds is not
    None). Returns (out, lse, route)."""
    _check(q, k, v, what)
    rt = route(q)
    if rt == "sm90":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    head = [_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse)]
    tail = [b, s_q, s_k, h, h_kv, d, float(scale), int(bool(causal)),
            _build.dtype_code(q), _build.stream(q)]
    src, sym = entry("fwd", bounds is not None, q)
    if bounds is None:
        fn = _build.function(src, sym, _ARGS)
        _build.check(fn(*head, *tail), what)
    else:
        fn = _build.function(src, sym, _ARGS[:5] + _MASK_ARGS + _ARGS[5:])
        _build.check(fn(*head, *_check_bounds(q, k, bounds, what), *tail),
                     what)
    return out, lse, rt


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> (out, lse [B, H, S_q]).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    out, lse, rt = _fwd(q, k, v, causal, scale, None, "flash_attention_fwd")
    _count(flash_attention_fwd, rt)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0
flash_attention_fwd.simt_launches = 0


def flashmask_attention_fwd_plain(q, k, v, start, end, start2=None,
                                  end2=None, causal=True, scale=None, *,
                                  p_dtype=None):
    """(out, lse) of attention in which query rows in [start[t], end[t])
    (and [start2[t], end2[t])) cannot see key t; bounds [B, kh, S_k]."""
    return flash_attention_fwd_plain(q, k, v, causal, scale,
                                     (start, end, start2, end2),
                                     p_dtype=p_dtype)


def flashmask_attention_fwd(q, k, v, start, end, start2=None, end2=None,
                            causal=True, scale=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D]; bounds int32 [B, kh,
    S_k] -> (out, lse [B, H, S_q]). CPU tensors take the plain version;
    CUDA tensors launch the masked kernel (or raise)."""
    if q.device.type == "cpu":
        return flashmask_attention_fwd_plain(q, k, v, start, end, start2,
                                             end2, causal, scale)
    out, lse, rt = _fwd(q, k, v, causal, scale, (start, end, start2, end2),
                        "flashmask_attention_fwd")
    _count(flashmask_attention_fwd, rt)
    return out, lse


flashmask_attention_fwd.launches = 0
flashmask_attention_fwd.sm90_launches = 0
flashmask_attention_fwd.simt_launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                              scale=None, bounds=None, *, p_dtype=None):
    """q/out/dout: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D]; lse: the
    forward's [B, H, S_q] float32 -> (dq, dk, dv) in the types of q, k, v.
    bounds: the flashmask operands (start, end, start2, end2), or None.

    Everything runs in float32: delta = rowsum(dout * out), P recomputed as
    exp(S * scale - lse) and zeroed where masked, dS = P * (dP - delta). By
    default P and dS stay float32 for the dV, dK and dQ products, as in the
    SIMT kernels. With ``p_dtype`` they are rounded to it before those
    products, as in the tensor-core kernels and the TPU kernel
    (``flash_attention.py`` ``_bwd_dq_kernel``: dS to k's type;
    ``_bwd_dkv_kernel``: P to dout's, dS to q's type); dS itself is still
    computed from the float32 P. (``_flash_core_bwd`` also rounds each query
    head's dk/dv before the group sum; here, as in the kernels, the group
    sums in float32 and rounds once.)"""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s_q, h_kv, rep, d).float()
    dog = dout.reshape(b, s_q, h_kv, rep, d).float()
    kf, vf = k.float(), v.float()
    delta = (dog * out.reshape(b, s_q, h_kv, rep, d).float()).sum(-1)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    p = torch.exp(s - lse.reshape(b, h_kv, rep, s_q, 1))
    vis = _visible(b, s_q, s_k, h_kv, rep, causal, bounds, q.device)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if p_dtype is not None:
        p = p.to(p_dtype).float()
        ds = ds.to(p_dtype).float()
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return (dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _bwd(q, k, v, out, lse, dout, causal, scale, bounds, what):
    """Launch the two backward kernels of q's route (masked when bounds is
    not None). delta = rowsum(dout * out) is one float32 reduction here, as
    the JAX package computes it in XLA before its kernels. Returns (dq, dk,
    dv, route)."""
    _check(q, k, v, what)
    _build.require_cuda(q, what, out=out, lse=lse, dout=dout)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"{what}: out {tuple(out.shape)} {out.dtype} and "
                         f"dout {tuple(dout.shape)} {dout.dtype} must match "
                         f"q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s_q) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be [B, H, S_q] = {(b, h, s_q)} "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rt = route(q)
    if rt == "sm90":
        q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    head = [_build.ptr(t) for t in (q, k, v, dout, lse, delta, dq, dk, dv)]
    tail = [b, s_q, s_k, h, h_kv, d, float(scale), int(bool(causal)),
            _build.dtype_code(q), _build.stream(q)]
    src, sym = entry("bwd", bounds is not None, q)
    if bounds is None:
        fn = _build.function(src, sym, _BWD_ARGS)
        _build.check(fn(*head, *tail), what)
    else:
        fn = _build.function(src, sym,
                             _BWD_ARGS[:9] + _MASK_ARGS + _BWD_ARGS[9:])
        _build.check(fn(*head, *_check_bounds(q, k, bounds, what), *tail),
                     what)
    return dq, dk, dv, rt


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None):
    """(dq, dk, dv) of ``flash_attention_fwd``. CPU tensors take the plain
    version; CUDA tensors launch the two backward kernels (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         scale)
    *res, rt = _bwd(q, k, v, out, lse, dout, causal, scale, None,
                    "flash_attention_bwd")
    _count(flash_attention_bwd, rt)
    return tuple(res)


flash_attention_bwd.launches = 0
flash_attention_bwd.sm90_launches = 0
flash_attention_bwd.simt_launches = 0


def flashmask_attention_bwd_plain(q, k, v, out, lse, dout, start, end,
                                  start2=None, end2=None, causal=True,
                                  scale=None, *, p_dtype=None):
    """(dq, dk, dv) of ``flashmask_attention_fwd_plain``."""
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale,
                                     (start, end, start2, end2),
                                     p_dtype=p_dtype)


def flashmask_attention_bwd(q, k, v, out, lse, dout, start, end,
                            start2=None, end2=None, causal=True, scale=None):
    """(dq, dk, dv) of ``flashmask_attention_fwd``. CPU tensors take the
    plain version; CUDA tensors launch the masked dQ and dK/dV kernels (or
    raise)."""
    if q.device.type == "cpu":
        return flashmask_attention_bwd_plain(q, k, v, out, lse, dout, start,
                                             end, start2, end2, causal, scale)
    *res, rt = _bwd(q, k, v, out, lse, dout, causal, scale,
                    (start, end, start2, end2), "flashmask_attention_bwd")
    _count(flashmask_attention_bwd, rt)
    return tuple(res)


flashmask_attention_bwd.launches = 0
flashmask_attention_bwd.sm90_launches = 0
flashmask_attention_bwd.simt_launches = 0


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) through ``flash_attention_fwd``; the
    backward is ``flash_attention_bwd`` on the saved q, k, v, out and lse
    (the counterpart of ``_flash_core``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


class FlashmaskAttention(torch.autograd.Function):
    """(out, lse) = flashmask attention through ``flashmask_attention_fwd``;
    the backward is ``flashmask_attention_bwd`` on the saved q, k, v, out,
    lse and bounds (the counterpart of ``_flashmask_core``'s custom_vjp).
    The bounds get no gradient and lse is non-differentiable. start2/end2
    may be None."""

    @staticmethod
    def forward(ctx, q, k, v, start, end, start2, end2, causal, scale):
        out, lse = flashmask_attention_fwd(q, k, v, start, end, start2, end2,
                                           causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, start, end, start2, end2)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, start, end, start2, end2 = ctx.saved_tensors
        dq, dk, dv = flashmask_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), start, end, start2, end2,
            ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None
