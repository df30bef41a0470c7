"""Ragged paged attention: the counterpart of
``paddle_tpu/ops/pallas/ragged_attention.py`` (``_ragged_kernel`` /
``ragged_paged_attention_xla``, ``ragged_paged_attention``).

Rows of different query counts (prefill chunks, suffixes after a prefix
hit, decode rows with one query) attend causally over their own paged
contexts in one launch. ``ragged_paged_attention`` launches the CUDA
kernel ``csrc/ragged_attention.cu`` for CUDA tensors and takes the plain
version ``ragged_paged_attention_plain`` for CPU tensors. Both accumulate
in float32, return q's type and zero the padded query rows. Bound and
design: see the note in the CUDA source.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import NEG_INF, gather_pages

# query rows (query positions x heads of one KV group) that one block of
# the CUDA kernel owns; each page read is shared by all of them
TILE_ROWS = 64


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens, q_lens, scale=None):
    """q: [C, Q_max, H, D]; k_pages/v_pages: [N, page, H_kv, D];
    block_tables [C, P]; context_lens/q_lens [C] -> [C, Q_max, H, D].
    Query i of row r sits at position context_lens[r] - q_lens[r] + i;
    padded query rows (i >= q_lens[r]) return zeros."""
    return ragged_over_context(q, gather_pages(k_pages, block_tables),
                               gather_pages(v_pages, block_tables),
                               context_lens, q_lens, scale)


def ragged_over_context(q, k_seq, v_seq, context_lens, q_lens, scale=None):
    """The plain versions' ragged attention over gathered contexts:
    q [C, Q_max, H, D]; k_seq/v_seq [C, S, H_kv, D] float32 ->
    [C, Q_max, H, D] in q's type, padded query rows zeroed."""
    c, q_max, h, d = q.shape
    s_len, h_kv = k_seq.shape[1], k_seq.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // h_kv
    qg = q.reshape(c, q_max, h_kv, rep, d).float()
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k_seq) * scale
    ctx = context_lens.to(q.device).long()
    ql = q_lens.to(q.device).long()
    q_idx = torch.arange(q_max, device=q.device)
    q_pos = ctx[:, None] - ql[:, None] + q_idx[None, :]          # [C, Q]
    k_pos = torch.arange(s_len, device=q.device)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & \
        (k_pos[None, None, :] < ctx[:, None, None])              # [C, Q, S]
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqs,bsgd->bqgrd", p, v_seq)
    out = out.reshape(c, q_max, h, d).to(q.dtype)
    qvalid = q_idx[None, :] < ql[:, None]
    return out * qvalid[:, :, None, None]


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def tile_queries(q_max, rep):
    """Query positions per block: TILE_ROWS rows of one KV group, never
    more positions than the launch has."""
    return max(1, min(q_max, TILE_ROWS // rep))


def _check(q, k_pages, v_pages, block_tables, context_lens, q_lens):
    _build.require_cuda(q, "ragged_paged_attention", q=q, k_pages=k_pages,
                        v_pages=v_pages, block_tables=block_tables,
                        context_lens=context_lens, q_lens=q_lens)
    c, _, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d or h % k_pages.shape[2]:
        raise ValueError(
            f"ragged_paged_attention: q {tuple(q.shape)} and pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} disagree")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("ragged_paged_attention: q and the page pools must "
                         f"share one dtype, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}")
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens), ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"ragged_paged_attention: {name} must be int32")
    if block_tables.shape[0] != c or context_lens.shape != (c,) \
            or q_lens.shape != (c,):
        raise ValueError("ragged_paged_attention: row counts disagree")


def ragged_paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                           q_lens, scale=None):
    """q: [C, Q_max, H, D]; k_pages/v_pages: [N, page, H_kv, D];
    block_tables [C, P] int32; context_lens/q_lens [C] int32 ->
    [C, Q_max, H, D]. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages,
                                            block_tables, context_lens,
                                            q_lens, scale)
    _check(q, k_pages, v_pages, block_tables, context_lens, q_lens)
    c, q_max, h, d = q.shape
    _, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.function("ragged_attention", "ptt_ragged_attention", _ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                    _build.ptr(block_tables), _build.ptr(context_lens),
                    _build.ptr(q_lens), _build.ptr(out), c, q_max, h, h_kv,
                    d, page, block_tables.shape[1],
                    tile_queries(q_max, h // h_kv), float(scale),
                    _build.dtype_code(q), _build.stream(q)),
                 "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
