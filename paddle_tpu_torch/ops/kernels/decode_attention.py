"""Paged decode attention: the counterpart of
``paddle_tpu/ops/pallas/decode_attention.py`` (``_decode_kernel`` /
``paged_decode_attention_xla``, ``paged_decode_attention``).

One query token per sequence attends over its paged KV context.
``paged_decode_attention`` launches the CUDA kernel
``csrc/decode_attention.cu`` for CUDA tensors and takes the plain version
``paged_decode_attention_plain`` for CPU tensors. Both accumulate in
float32 and return q's type; a sequence with an empty context (an idle
slot) gets 0, as the Pallas kernel's finalize clamp gives. Bound and design:
see the note in the CUDA source (memory-bound, one block per
(sequence, KV head); split-K is the planned redesign).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30


def gather_pages(pages, block_tables):
    """Each row's context from the pool: pages [N, page, H_kv, D] and
    block_tables [B, P] -> [B, P * page, H_kv, D] float32."""
    b, p_max = block_tables.shape
    seq = pages[block_tables.long()].float()
    return seq.reshape(b, p_max * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens, scale=None):
    """q: [B, H, D]; k_pages/v_pages: [N, page, H_kv, D]; block_tables:
    [B, P] int; context_lens: [B] int -> [B, H, D]."""
    return decode_over_context(q, gather_pages(k_pages, block_tables),
                               gather_pages(v_pages, block_tables),
                               context_lens, scale)


def decode_over_context(q, k_seq, v_seq, context_lens, scale=None):
    """The plain versions' attention over gathered contexts: q [B, H, D];
    k_seq/v_seq [B, S, H_kv, D] float32; key s is visible when s <
    context_lens[b] -> [B, H, D] in q's type."""
    b, h, d = q.shape
    s_len, h_kv = k_seq.shape[1], k_seq.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // h_kv
    qg = q.reshape(b, h_kv, rep, d).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_seq) * scale
    pos = torch.arange(s_len, device=q.device)
    valid = pos[None, :] < context_lens.to(q.device)[:, None].long()
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    # masked keys already get exp(NEG_INF - max) == 0; the product zeroes
    # the rows of empty contexts, whose softmax would be uniform
    p = torch.softmax(s, dim=-1) * valid[:, None, None, :]
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_seq)
    return out.reshape(b, h, d).to(q.dtype)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(q, k_pages, v_pages, block_tables, context_lens):
    _build.require_cuda(q, "paged_decode_attention", q=q, k_pages=k_pages,
                        v_pages=v_pages, block_tables=block_tables,
                        context_lens=context_lens)
    b, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d or h % k_pages.shape[2]:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} and pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} disagree")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("paged_decode_attention: q and the page pools must "
                         f"share one dtype, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_decode_attention: block_tables and "
                         "context_lens must be int32")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("paged_decode_attention: batch sizes disagree")


def paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                           scale=None):
    """q: [B, H, D]; k_pages/v_pages: [N, page, H_kv, D]; block_tables:
    [B, P] int32; context_lens: [B] int32 -> [B, H, D]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, context_lens, scale)
    _check(q, k_pages, v_pages, block_tables, context_lens)
    b, h, d = q.shape
    _, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "ptt_decode_attention", _ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                    _build.ptr(block_tables), _build.ptr(context_lens),
                    _build.ptr(out), b, h, h_kv, d, page,
                    block_tables.shape[1], float(scale),
                    _build.dtype_code(q), _build.stream(q)),
                 "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
