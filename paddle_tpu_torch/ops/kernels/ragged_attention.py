"""Ragged paged attention: the counterpart of
``paddle_tpu/ops/pallas/ragged_attention.py`` (``_ragged_kernel`` /
``ragged_paged_attention_xla``, ``ragged_paged_attention``).

Rows of different query counts (prefill chunks, suffixes after a prefix
hit, decode rows with one query) attend causally over their own paged
contexts in one launch. ``ragged_paged_attention`` launches a CUDA kernel
for CUDA tensors and takes the plain version
``ragged_paged_attention_plain`` for CPU tensors. Both accumulate in
float32, return q's type and zero the padded query rows.

Two routes, chosen by type, head dim and page size (``route``), never by
failure: bfloat16 and float16 with D in {64, 128} and pages of a multiple
of 8 tokens launch the tensor-core kernel ``csrc/ragged_sm90.cu`` (wgmma
on TMA-staged pages; P rounded to q's type before the P V product, where
the TPU kernel keeps it float32); everything else (float32, other head
dims, pages of 4) launches the float32 SIMT kernel
``csrc/ragged_attention.cu`` (P kept float32). The wrapper counts its
launches in ``launches`` and per route in ``sm90_launches`` /
``simt_launches``.

The plain versions keep P in float32 by default; ``p_dtype`` rounds it
where the tensor-core kernel does. ``ragged_paged_attention_tiled_plain``
is the kernel's own walk (query tiles of flat rows, an online softmax over
key tiles that cross pages), the tests' model of the kernel; nothing on
the serving path calls it. Bound and design: see the notes in the CUDA
sources.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .decode_attention import NEG_INF, gather_pages
from .flash_attention import L_EPS, _aligned, _count

# query rows (query positions x heads of one KV group) that one block of
# the SIMT kernel owns; each page read is shared by all of them
TILE_ROWS = 64
# the tensor-core route: its types and head dims, the page sizes its TMA
# boxes take, and its tiles (flat query rows a block, keys a tile)
SM90_DTYPES = (torch.bfloat16, torch.float16)
SM90_HEAD_DIMS = (64, 128)
SM90_PAGE_MULTIPLE = 8
SM90_BLOCK_ROWS = 128
SM90_BLOCK_K = 64


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens, q_lens, scale=None, *,
                                 p_dtype=None):
    """q: [C, Q_max, H, D]; k_pages/v_pages: [N, page, H_kv, D];
    block_tables [C, P]; context_lens/q_lens [C] -> [C, Q_max, H, D].
    Query i of row r sits at position context_lens[r] - q_lens[r] + i;
    padded query rows (i >= q_lens[r]) return zeros. p_dtype: see
    ``ragged_over_context``."""
    return ragged_over_context(q, gather_pages(k_pages, block_tables),
                               gather_pages(v_pages, block_tables),
                               context_lens, q_lens, scale, p_dtype=p_dtype)


def ragged_over_context(q, k_seq, v_seq, context_lens, q_lens, scale=None,
                        *, p_dtype=None, v_mult=None):
    """The plain versions' ragged attention over gathered contexts:
    q [C, Q_max, H, D]; k_seq/v_seq [C, S, H_kv, D] float32 ->
    [C, Q_max, H, D] in q's type, padded query rows zeroed.

    By default P stays float32 (softmax, then the P V product), as in the
    TPU kernel and the SIMT kernel. With ``p_dtype`` (the tensor-core
    kernel's rounding) the normalizer l sums float32 P, P is rounded to
    p_dtype before the P V product, which sums in float32, and the sum is
    divided by l at the end, as the flash plain version does. v_mult
    [C, S] (int8 pages: v_seq holds the codes) multiplies each key's P
    before the rounding, as the kernel folds the V scale."""
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
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrqs,bsgd->bqgrd", p, v_seq)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid[:, None, None]
        lc = p.sum(dim=-1).clamp_min(L_EPS)                    # [C,G,R,Q]
        if v_mult is not None:
            p = p * v_mult[:, None, None, None, :]
        p = p.to(p_dtype).float()
        out = torch.einsum("bgrqs,bsgd->bqgrd", p, v_seq) / \
            lc.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(c, q_max, h, d).to(q.dtype)
    qvalid = q_idx[None, :] < ql[:, None]
    return out * qvalid[:, :, None, None]


def ragged_tiled_over_context(q, k_seq, v_seq, context_lens, q_lens,
                              scale=None, *, block_rows, block_k,
                              p_dtype=None, k_mult=None, v_mult=None):
    """The tensor-core kernel's walk over gathered contexts (q, k_seq,
    v_seq as ``ragged_over_context``): per row and query tile of
    `block_rows` flat rows (query-major j = q_idx * rep + r, so
    block_rows // rep positions), an online softmax over key tiles of
    `block_k` keys (crossing pages) up to the last key the tile's last real
    query sees. Scores, the running max and l are float32; l sums float32
    P; with p_dtype, P (times v_mult, the V multiplier per key [C, S], for
    int8 codes) is rounded before the P V product. k_mult [C, S] multiplies
    each key's score column (int8: k_seq holds the codes)."""
    c, q_max, h, d = q.shape
    s_len, h_kv = k_seq.shape[1], k_seq.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // h_kv
    qt = max(1, min(block_rows // rep, q_max))
    qg = q.reshape(c, q_max, h_kv, rep, d).float()
    out = torch.zeros(c, q_max, h_kv, rep, d, device=q.device)
    for r, (ctx, q_len) in enumerate(zip(context_lens.tolist(),
                                         q_lens.tolist())):
        for q0 in range(0, min(q_len, q_max), qt):
            q_end = min(q0 + qt, q_max)
            qi = torch.arange(q0, q_end, device=q.device)
            lim = torch.where(qi < q_len,
                              torch.clamp(ctx - q_len + qi, max=ctx - 1), -1)
            n_keys = max(0, min(min(ctx - q_len + min(q_end, q_len) - 1,
                                    ctx - 1) + 1, s_len))
            x = qg[r, q0:q_end]                               # [QT,G,R,D]
            m = torch.full(x.shape[:3], NEG_INF, device=q.device)
            l = torch.zeros(x.shape[:3], device=q.device)
            acc = torch.zeros_like(x)
            for k0 in range(0, n_keys, block_k):
                k1 = min(k0 + block_k, s_len)
                sc = torch.einsum("qgrd,kgd->qgrk", x, k_seq[r, k0:k1])
                sc = sc * scale
                if k_mult is not None:
                    sc = sc * k_mult[r, k0:k1]
                vis = torch.arange(k0, k1, device=q.device)[None] <= \
                    lim[:, None]                               # [QT, K]
                sc = sc.masked_fill(~vis[:, None, None], float("-inf"))
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = alpha * l + p.sum(dim=-1)
                if v_mult is not None:
                    p = p * v_mult[r, k0:k1]
                if p_dtype is not None:
                    p = p.to(p_dtype).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "qgrk,kgd->qgrd", p, v_seq[r, k0:k1])
                m = m_new
            out[r, q0:q_end] = acc / l.clamp_min(L_EPS)[..., None]
    return out.reshape(c, q_max, h, d).to(q.dtype)


def ragged_paged_attention_tiled_plain(q, k_pages, v_pages, block_tables,
                                       context_lens, q_lens, scale=None, *,
                                       block_rows=SM90_BLOCK_ROWS,
                                       block_k=SM90_BLOCK_K, p_dtype=None):
    """``ragged_paged_attention_plain`` computed as the tensor-core kernel
    computes it (``ragged_tiled_over_context``): the tests' model of the
    kernel. Nothing on the serving path calls it."""
    return ragged_tiled_over_context(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), context_lens, q_lens, scale,
        block_rows=block_rows, block_k=block_k, p_dtype=p_dtype)


def route(q, page):
    """The kernel route of a launch on q over pages of `page` tokens:
    "sm90" (tensor cores) for bfloat16/float16 with head dim 64 or 128 and
    pages of a multiple of 8 tokens (a TMA box of whole 8-row swizzle
    atoms), else "simt" (float32 CUDA cores). A stated routing by type and
    shape, read on the host from shapes alone: the float32 checks hold the
    SIMT kernel to 1e-4, which TF32 products would break, and the tiny
    model's pages of 4 make no 8-row box."""
    if q.dtype in SM90_DTYPES and q.shape[-1] in SM90_HEAD_DIMS and \
            page % SM90_PAGE_MULTIPLE == 0:
        return "sm90"
    return "simt"


# both routes' entries: the SIMT one's last int is the query tile, the
# tensor-core one's the pool's page count (the extent of its tensor maps)
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
    launch the route's kernel (or raise)."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages,
                                            block_tables, context_lens,
                                            q_lens, scale)
    _check(q, k_pages, v_pages, block_tables, context_lens, q_lens)
    c, q_max, h, d = q.shape
    n, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rt = route(q, page)
    if rt == "sm90":
        q, k_pages, v_pages = _aligned(q), _aligned(k_pages), \
            _aligned(v_pages)
        src, sym, last = "ragged_sm90", "ptt_ragged_attention_sm90", n
    else:
        src, sym, last = "ragged_attention", "ptt_ragged_attention", \
            tile_queries(q_max, h // h_kv)
    out = torch.empty_like(q)
    rc = _build.function(src, sym, _ARGS)(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(block_tables), _build.ptr(context_lens),
        _build.ptr(q_lens), _build.ptr(out), c, q_max, h, h_kv, d, page,
        block_tables.shape[1], last, float(scale), _build.dtype_code(q),
        _build.stream(q))
    _build.check(rc, "ragged_paged_attention")
    _count(ragged_paged_attention, rt)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.sm90_launches = 0
ragged_paged_attention.simt_launches = 0
