"""Dequant-fused paged attention over int8 KV pages: the counterpart of
``paddle_tpu/ops/pallas/quantized_attention.py`` (``_decode_int8_kernel``
/ ``paged_decode_attention_int8_xla`` and ``_ragged_int8_kernel`` /
``ragged_paged_attention_int8_xla``).

The pools hold int8 codes with one float32 scale per page
(``quantization.page_quant``); a page's values are ``code * (scale *
INV_QMAX)``. ``paged_decode_attention_int8`` and
``ragged_paged_attention_int8`` launch the CUDA kernels of
``csrc/quantized_attention.cu`` (the float kernels' templates with the
dequant fused in: the ragged kernel's page staging, the decode kernel's
per-page score and probability multipliers) for CUDA tensors, and take the
plain versions for CPU tensors. The ragged wrapper takes the float
wrapper's two routes (``ragged_attention.route``): bfloat16/float16 q with
D 64 or 128 and pages of a multiple of 8 launch the tensor-core kernel
``csrc/ragged_sm90.cu`` (int8 codes staged raw, turned into 16-bit values
in shared memory, the K and V scales folded into the scores and P), the
rest the SIMT kernel; launches are counted per route. The decode kernel
takes the float kernel's split plan and workspace
(``decode_attention.split_plan``); ``paged_decode_attention_int8_split_plain``
is its split-K algorithm in plain PyTorch, and
``ragged_paged_attention_int8_tiled_plain`` the tensor-core ragged
kernel's walk. The plain versions gather each row's context and dequantize
what they gathered, never the pool, then attend as the float plain
versions do (an empty context gives 0, padded query rows 0).

The wrappers refuse pages that are not int8 and scales that are not one
float32 row per page: they never cast a pool and never fall back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...quantization.page_quant import INV_QMAX
from . import _build, _cost
from .decode_attention import (checked_plan, decode_over_context,
                               decode_split_over_context, split_plan,
                               workspace)
from .flash_attention import _aligned, _count
from .ragged_attention import (SM90_BLOCK_K, SM90_BLOCK_ROWS,
                               ragged_over_context,
                               ragged_tiled_over_context, route,
                               tile_queries)


def key_multipliers(scales, block_tables, page):
    """scales [N] + block_tables [B, P] -> [B, P * page] float32: each
    gathered key's page scale * INV_QMAX (the kernels' per-key multiplier
    of int8 codes)."""
    return (scales[block_tables.long()] * INV_QMAX).repeat_interleave(
        page, dim=1)


def _codes(pages, block_tables):
    """int8 pages gathered as float32 codes [B, P * page, H_kv, D]."""
    b, p_max = block_tables.shape
    return pages[block_tables.long()].float().reshape(
        b, p_max * pages.shape[1], *pages.shape[2:])


def gather_dequant(pages, scales, block_tables):
    """int8 pages [N, page, H_kv, D] + scales [N] + block_tables [B, P] ->
    [B, P * page, H_kv, D] float32: the gathered context only, each page
    multiplied by its scale * INV_QMAX (the JAX reference's order)."""
    mult = key_multipliers(scales, block_tables, pages.shape[1])
    return _codes(pages, block_tables) * mult[:, :, None, None]


def paged_decode_attention_int8_plain(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, context_lens,
                                      scale=None):
    """q: [B, H, D]; k_pages/v_pages: [N, page, H_kv, D] int8;
    k_scales/v_scales: [N] float32; block_tables: [B, P] int;
    context_lens: [B] int -> [B, H, D] in q's type."""
    return decode_over_context(
        q, gather_dequant(k_pages, k_scales, block_tables),
        gather_dequant(v_pages, v_scales, block_tables), context_lens, scale)


def paged_decode_attention_int8_split_plain(q, k_pages, v_pages, k_scales,
                                            v_scales, block_tables,
                                            context_lens, scale=None,
                                            pages_per_split=None):
    """``paged_decode_attention_int8_plain`` computed as the kernel
    computes it: split-K over ranges of `pages_per_split` pages (by
    default the kernel's plan), then the merge."""
    b, h, _ = q.shape
    _, page, h_kv, _ = k_pages.shape
    if pages_per_split is None:
        pages_per_split = split_plan(b, h, h_kv, block_tables.shape[1],
                                     page)[1]
    return decode_split_over_context(
        q, gather_dequant(k_pages, k_scales, block_tables),
        gather_dequant(v_pages, v_scales, block_tables), context_lens, page,
        pages_per_split, scale)


def ragged_paged_attention_int8_plain(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, context_lens,
                                      q_lens, scale=None, *, p_dtype=None):
    """q: [C, Q_max, H, D]; int8 pages and float32 scales as
    ``paged_decode_attention_int8_plain``; block_tables [C, P];
    context_lens/q_lens [C] -> [C, Q_max, H, D], padded query rows 0.
    With p_dtype, P times each key's V multiplier (v_scale / 127) is
    rounded to p_dtype before the product with the V codes, where the
    tensor-core kernel rounds it."""
    k_seq = gather_dequant(k_pages, k_scales, block_tables)
    if p_dtype is None:
        return ragged_over_context(
            q, k_seq, gather_dequant(v_pages, v_scales, block_tables),
            context_lens, q_lens, scale)
    return ragged_over_context(
        q, k_seq, _codes(v_pages, block_tables), context_lens, q_lens,
        scale, p_dtype=p_dtype,
        v_mult=key_multipliers(v_scales, block_tables, v_pages.shape[1]))


def ragged_paged_attention_int8_tiled_plain(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
        q_lens, scale=None, *, block_rows=SM90_BLOCK_ROWS,
        block_k=SM90_BLOCK_K, p_dtype=None):
    """``ragged_paged_attention_int8_plain`` computed as the tensor-core
    kernel computes it: scores of the codes times each key's K multiplier,
    P times each key's V multiplier (rounded with p_dtype) against the V
    codes, in the kernel's tiles (``ragged_tiled_over_context``). The
    tests' model of the kernel; nothing on the serving path calls it."""
    page = k_pages.shape[1]
    return ragged_tiled_over_context(
        q, _codes(k_pages, block_tables), _codes(v_pages, block_tables),
        context_lens, q_lens, scale, block_rows=block_rows, block_k=block_k,
        p_dtype=p_dtype,
        k_mult=key_multipliers(k_scales, block_tables, page),
        v_mult=key_multipliers(v_scales, block_tables, page))


def _check(what, q, rank, k_pages, v_pages, k_scales, v_scales, rows):
    """Types and shapes, for the plain version and the kernel alike."""
    if q.dim() != rank:
        raise ValueError(f"{what}: q must have rank {rank}, got "
                         f"{tuple(q.shape)}")
    d, h = q.shape[-1], q.shape[-2]
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4 \
            or k_pages.shape[3] != d or h % k_pages.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         "disagree")
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{what}: pages must be int8 codes, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    n = k_pages.shape[0]
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        if s.dtype != torch.float32 or s.shape != (n,):
            raise TypeError(f"{what}: {name} must be float32 [{n}] (one row "
                            f"per page), got {s.dtype} {tuple(s.shape)}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"{what}: q must be floating point, got {q.dtype}")
    for name, t in rows.items():
        if t.shape[0] != q.shape[0]:
            raise ValueError(f"{what}: {name} has {t.shape[0]} rows, q "
                             f"{q.shape[0]}")


def _check_cuda(what, q, **tensors):
    _build.require_cuda(q, what, q=q, **tensors)
    for name in ("block_tables", "context_lens", "q_lens"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32")


_DECODE_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# both routes' ragged entries (the last int as in ragged_attention._ARGS)
_RAGGED_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@_cost.costed("paged_decode_attention_int8", _cost.decode_int8)
def paged_decode_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, context_lens, scale=None):
    """q: [B, H, D] float; k_pages/v_pages: [N, page, H_kv, D] int8;
    k_scales/v_scales: [N] float32; block_tables: [B, P] int32;
    context_lens: [B] int32 -> [B, H, D] in q's type. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    what = "paged_decode_attention_int8"
    _check(what, q, 3, k_pages, v_pages, k_scales, v_scales,
           {"block_tables": block_tables, "context_lens": context_lens})
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            context_lens, scale)
    _check_cuda(what, q, k_pages=k_pages, v_pages=v_pages,
                k_scales=k_scales, v_scales=v_scales,
                block_tables=block_tables, context_lens=context_lens)
    b, h, d = q.shape
    _, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    p_max = block_tables.shape[1]
    splits, _ = checked_plan(b, h, h_kv, p_max, page)
    out = torch.empty_like(q)
    ws = workspace(q, splits)
    fn = _build.function("quantized_attention", "ptt_decode_attention_int8",
                         _DECODE_ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                    _build.ptr(k_scales), _build.ptr(v_scales),
                    _build.ptr(block_tables), _build.ptr(context_lens),
                    _build.ptr(out), _build.ptr_or_null(ws), b, h, h_kv, d,
                    page, p_max, float(scale), _build.dtype_code(q),
                    _build.stream(q)), what)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0


@_cost.costed("ragged_paged_attention_int8", _cost.ragged_int8)
def ragged_paged_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, context_lens, q_lens,
                                scale=None):
    """q: [C, Q_max, H, D] float; int8 pages and float32 scales as
    ``paged_decode_attention_int8``; block_tables [C, P] int32;
    context_lens/q_lens [C] int32 -> [C, Q_max, H, D]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    what = "ragged_paged_attention_int8"
    _check(what, q, 4, k_pages, v_pages, k_scales, v_scales,
           {"block_tables": block_tables, "context_lens": context_lens,
            "q_lens": q_lens})
    if q.device.type == "cpu":
        return ragged_paged_attention_int8_plain(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            context_lens, q_lens, scale)
    _check_cuda(what, q, k_pages=k_pages, v_pages=v_pages,
                k_scales=k_scales, v_scales=v_scales,
                block_tables=block_tables, context_lens=context_lens,
                q_lens=q_lens)
    c, q_max, h, d = q.shape
    n, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rt = route(q, page)
    if rt == "sm90":
        q, k_pages, v_pages = _aligned(q), _aligned(k_pages), \
            _aligned(v_pages)
        src, sym, last = "ragged_sm90", "ptt_ragged_attention_int8_sm90", n
    else:
        src, sym, last = "quantized_attention", \
            "ptt_ragged_attention_int8", tile_queries(q_max, h // h_kv)
    out = torch.empty_like(q)
    rc = _build.function(src, sym, _RAGGED_ARGS)(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(k_scales), _build.ptr(v_scales), _build.ptr(block_tables),
        _build.ptr(context_lens), _build.ptr(q_lens), _build.ptr(out), c,
        q_max, h, h_kv, d, page, block_tables.shape[1], last, float(scale),
        _build.dtype_code(q), _build.stream(q))
    _build.check(rc, what)
    _count(ragged_paged_attention_int8, rt)
    return out


ragged_paged_attention_int8.launches = 0
ragged_paged_attention_int8.sm90_launches = 0
ragged_paged_attention_int8.simt_launches = 0
