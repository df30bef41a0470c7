"""Paged decode attention: the counterpart of
``paddle_tpu/ops/pallas/decode_attention.py`` (``_decode_kernel`` /
``paged_decode_attention_xla``, ``paged_decode_attention``).

One query token per sequence attends over its paged KV context.
``paged_decode_attention`` launches the CUDA kernel
``csrc/decode_attention.cu`` for CUDA tensors and takes the plain version
``paged_decode_attention_plain`` for CPU tensors. Both accumulate in
float32 and return q's type; a sequence with an empty context (an idle
slot) gets 0, as the Pallas kernel's finalize clamp gives. Bound and design:
see the note in ``csrc/decode_attention.cuh`` (memory-bound; split-K over
pages, then a merge of the partials).

``split_plan`` is the kernel's plan (how many page ranges, of how many
pages) as a function of static shapes alone, and sizes the workspace of
partials; ``decode_split_over_context`` is the split-K algorithm in plain
PyTorch (partials per page range, then the merge), which the tests hold
against the Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, _cost

NEG_INF = -1e30
L_EPS = 1e-30      # the finalize's clamp of the normalizer (common.cuh)


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


def decode_split_over_context(q, k_seq, v_seq, context_lens, page,
                              pages_per_split, scale=None):
    """The kernel's split-K algorithm over gathered contexts (arguments as
    ``decode_over_context``; S a whole number of pages): each range of
    `pages_per_split` pages gives a partial (running max m_i, normalizer
    l_i, unnormalized accumulator acc_i; a range with no visible key gives
    m_i = NEG_INF, l_i = 0), then the merge m = max m_i, acc = sum
    exp(m_i - m) acc_i, l likewise, out = acc / max(l, L_EPS), with the
    partials of l_i = 0 weighted 0. -> [B, H, D] in q's type."""
    b, h, d = q.shape
    s_len, h_kv = k_seq.shape[1], k_seq.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // h_kv
    span = pages_per_split * page
    splits = -(-s_len // span)
    pad = splits * span - s_len
    if pad:
        k_seq = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
        v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(b, h_kv, rep, d).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_seq) * scale
    pos = torch.arange(splits * span, device=q.device)
    valid = (pos[None, :] < context_lens.to(q.device)[:, None].long())
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF).reshape(b, h_kv, rep, splits, span)
    valid = valid.reshape(b, 1, 1, splits, span)
    m_i = s.amax(-1)
    p = torch.exp(s - m_i[..., None]) * valid
    l_i = p.sum(-1)
    acc_i = torch.einsum("bgrnt,bntgd->bgrnd", p,
                         v_seq.reshape(b, splits, span, h_kv, d))
    live = l_i > 0
    m = torch.where(live, m_i, torch.full_like(m_i, NEG_INF)).amax(-1)
    w = torch.where(live, torch.exp(m_i - m[..., None]),
                    torch.zeros_like(m_i))
    l = (w * l_i).sum(-1)
    acc = (w[..., None] * acc_i).sum(-2)
    out = acc / l.clamp_min(L_EPS)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_split_plain(q, k_pages, v_pages, block_tables,
                                       context_lens, scale=None,
                                       pages_per_split=None):
    """``paged_decode_attention_plain`` computed as the kernel computes it:
    split-K over ranges of `pages_per_split` pages (by default the
    kernel's plan, ``split_plan``), then the merge."""
    b, h, _ = q.shape
    _, page, h_kv, _ = k_pages.shape
    if pages_per_split is None:
        pages_per_split = split_plan(b, h, h_kv, block_tables.shape[1],
                                     page)[1]
    return decode_split_over_context(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), context_lens, page,
        pages_per_split, scale)


# the split plan's constants (csrc/decode_attention.cuh DECODE_*)
MAX_REP = 8
MIN_SPLIT_TOKENS = 64
MAX_SPLITS = 64


def split_plan(b, h, h_kv, p_max, page):
    """(splits, pages per split) of the decode kernel for these static
    shapes -- batch, query heads, KV heads, block-table width and page
    size -- and nothing else: never the context lengths, which stay on
    the device. A split covers as many keys as there are (sequence, KV
    head, row group of <= MAX_REP query heads) triples, at least
    MIN_SPLIT_TOKENS, in whole pages; at most MAX_SPLITS a row. The C twin
    is ``decode_split_plan`` (csrc/decode_attention.cuh);
    ``paged_decode_attention`` holds the two equal."""
    if p_max <= 0 or page <= 0 or h_kv <= 0 or b <= 0:
        return 1, max(p_max, 1)
    groups = max(-(-(h // h_kv) // MAX_REP), 1)
    tokens = max(b * h_kv * groups, MIN_SPLIT_TOKENS)
    per = min(max(tokens // page, 1), p_max)
    n = -(-p_max // per)
    if n > MAX_SPLITS:
        per = -(-p_max // MAX_SPLITS)
        n = -(-p_max // per)
    return n, per


def workspace(q, splits):
    """The float32 partials of one launch, [B * H * splits * (D + 2)]
    (accumulators, maxima, normalizers), from the caching allocator; None
    for a one-split plan, which writes out directly."""
    if splits == 1:
        return None
    b, h, d = q.shape
    return torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)


@functools.cache
def checked_plan(b, h, h_kv, p_max, page):
    """``split_plan``, held equal to the C plan (``ptt_decode_split_plan``,
    a host function: no device access) once per shape; the workspace it
    sizes must hold every partial the kernel writes."""
    plan = split_plan(b, h, h_kv, p_max, page)
    got = (ctypes.c_int * 2)()
    fn = _build.load("decode_attention").ptt_decode_split_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    fn(b, h, h_kv, p_max, page, got)
    if tuple(got) != plan:
        raise RuntimeError(f"paged decode: the C split plan {tuple(got)} "
                           f"!= split_plan {plan} for "
                           f"{(b, h, h_kv, p_max, page)}")
    return plan


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
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


@_cost.costed("paged_decode_attention", _cost.decode)
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
    p_max = block_tables.shape[1]
    splits, _ = checked_plan(b, h, h_kv, p_max, page)
    out = torch.empty_like(q)
    ws = workspace(q, splits)
    fn = _build.function("decode_attention", "ptt_decode_attention", _ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                    _build.ptr(block_tables), _build.ptr(context_lens),
                    _build.ptr(out), _build.ptr_or_null(ws), b, h, h_kv, d,
                    page, p_max, float(scale), _build.dtype_code(q),
                    _build.stream(q)),
                 "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
