"""Flash attention, forward: the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd_bhsd`` /
``_fwd_kernel``, ``flash_attention_fwd``, reference
``_sdpa_reference_gqa``) and of ``paddle_tpu/ops/primitive/
lowering_gpu.py`` (``_flash_fwd_gpu``), which compute the same function.

``flash_attention_fwd`` launches the CUDA kernel ``csrc/flash_attention.cu``
for CUDA tensors and takes the plain version ``flash_attention_fwd_plain``
for CPU tensors. Both take paddle's layout, mask causally with bottom-right
alignment, read K/V heads by index under GQA, accumulate in float32, and
return ``(out, lse)``: out in q's type, lse ``[B, H, S_q]`` float32 (the
TPU kernel's lane-broadcast lse layout is dropped). Bound and design: see
the note in the CUDA source.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import NEG_INF

L_EPS = 1e-30          # the finalize's clamp of the normalizer
MAX_HEAD_DIM = 256     # head dims the CUDA kernel takes: D % 8 == 0, <= this


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
        cm = torch.ones(s_q, s_k, dtype=torch.bool,
                        device=q.device).tril(s_k - s_q)
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


def _check(q, k, v):
    _build.require_cuda(q, "flash_attention_fwd", q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[B, S, H, D] with k and v alike")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         "heads not a multiple of the KV heads)")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: the CUDA kernel takes head "
                         f"dims that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_fwd: q, k and v must share one "
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
