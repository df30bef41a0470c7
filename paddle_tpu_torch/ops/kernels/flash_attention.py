"""Flash attention, forward and backward: the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd_bhsd`` /
``_fwd_kernel``, ``flash_attention_fwd``, reference
``_sdpa_reference_gqa``; the backward ``_flash_bwd_bhsd`` with
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` and the glue ``_flash_core_fwd``
/ ``_flash_core_bwd``) and of ``paddle_tpu/ops/primitive/lowering_gpu.py``
(``_flash_fwd_gpu``), which computes the same forward.

``flash_attention_fwd`` launches the CUDA kernel ``csrc/flash_attention.cu``
for CUDA tensors and takes the plain version ``flash_attention_fwd_plain``
for CPU tensors. Both take paddle's layout, mask causally with bottom-right
alignment, read K/V heads by index under GQA, accumulate in float32, and
return ``(out, lse)``: out in q's type, lse ``[B, H, S_q]`` float32 (the
TPU kernel's lane-broadcast lse layout is dropped).

``flash_attention_bwd`` (CUDA kernels ``csrc/flash_attention_bwd.cu``) and
``flash_attention_bwd_plain`` give (dq, dk, dv) from q, k, v, the forward's
out and lse, and the output's gradient; dk/dv are already summed over each
KV head's group of query heads. ``FlashAttention`` is the autograd
function that pairs the two: its forward is the forward kernel and it
saves q, k, v, out and the float32 lse. Bound and design: see the notes in
the CUDA sources.
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


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> (out [B, S_q, H, D] in
    q's type, lse [B, H, S_q] float32).

    Scores, softmax and the PV product run in float32, and P stays float32
    for the PV product, as in ``_flash_fwd_gpu``. (The TPU kernel rounds P
    to v's type and ``_sdpa_reference`` rounds the probabilities to q's type
    first: in bfloat16 that moves outputs by up to ~1e-2, inside the bf16
    attention tolerance of 2e-2.) A row with no visible key writes 0 and
    lse = NEG_INF + log(L_EPS), the finalize's clamp, as the kernels do."""
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s_q, h_kv, rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale
    if causal:
        cm = _causal_mask(s_q, s_k, q.device)
        s = s.masked_fill(~cm, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p * cm           # rows with no visible key: exp(0) -> 0
    lc = p.sum(dim=-1, keepdim=True).clamp_min(L_EPS)
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    out = acc / lc.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(lc))[..., 0].reshape(b, h, s_q)
    return out.reshape(b, s_q, h, d).to(q.dtype), lse


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D] -> (out, lse [B, H, S_q]).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check(q, k, v)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "ptt_flash_attention_fwd", _ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                    _build.ptr(out), _build.ptr(lse), b, s_q, s_k, h, h_kv, d,
                    float(scale), int(bool(causal)), _build.dtype_code(q),
                    _build.stream(q)), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                              scale=None):
    """q/out/dout: [B, S_q, H, D]; k/v: [B, S_k, H_kv, D]; lse: the
    forward's [B, H, S_q] float32 -> (dq, dk, dv) in the types of q, k, v.

    Everything runs in float32: delta = rowsum(dout * out), P recomputed as
    exp(S * scale - lse) and zeroed where masked, and P and dS stay float32
    for the dV, dK and dQ products, as in the CUDA kernels. (The TPU kernel
    rounds P and dS to the input type before those products, and
    ``_flash_core_bwd`` rounds each query head's dk/dv before the group sum:
    in bfloat16 that moves gradients by about one bf16 rounding.)"""
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
    if causal:
        p = p.masked_fill(~_causal_mask(s_q, s_k, q.device), 0.0)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return (dq.reshape(b, s_q, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None):
    """(dq, dk, dv) of ``flash_attention_fwd``. CPU tensors take the plain
    version; CUDA tensors launch the two backward kernels (or raise).
    delta = rowsum(dout * out) is one float32 reduction here, as the JAX
    package computes it in XLA before its kernels."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         scale)
    _check(q, k, v, "flash_attention_bwd")
    _build.require_cuda(q, "flash_attention_bwd", out=out, lse=lse,
                        dout=dout)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.shape != (b, h, s_q) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be [B, H, S_q] = "
                         f"{(b, h, s_q)} float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.function("flash_attention_bwd", "ptt_flash_attention_bwd",
                         _BWD_ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                    _build.ptr(dout), _build.ptr(lse), _build.ptr(delta),
                    _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), b, s_q,
                    s_k, h, h_kv, d, float(scale), int(bool(causal)),
                    _build.dtype_code(q), _build.stream(q)),
                 "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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
