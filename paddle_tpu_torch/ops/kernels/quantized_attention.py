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
plain versions for CPU tensors. The decode kernel takes the float
kernel's split plan and workspace (``decode_attention.split_plan``);
``paged_decode_attention_int8_split_plain`` is its split-K algorithm in
plain PyTorch. The plain versions gather each row's context
and dequantize what they gathered, never the pool, then attend as the
float plain versions do (an empty context gives 0, padded query rows 0).

The wrappers refuse pages that are not int8 and scales that are not one
float32 row per page: they never cast a pool and never fall back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...quantization.page_quant import INV_QMAX
from . import _build
from .decode_attention import (checked_plan, decode_over_context,
                               decode_split_over_context, split_plan,
                               workspace)
from .ragged_attention import ragged_over_context, tile_queries


def gather_dequant(pages, scales, block_tables):
    """int8 pages [N, page, H_kv, D] + scales [N] + block_tables [B, P] ->
    [B, P * page, H_kv, D] float32: the gathered context only, each page
    multiplied by its scale * INV_QMAX (the JAX reference's order)."""
    b, p_max = block_tables.shape
    bt = block_tables.long()
    seq = pages[bt].float() * (scales[bt] * INV_QMAX)[:, :, None, None, None]
    return seq.reshape(b, p_max * pages.shape[1], *pages.shape[2:])


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
                                      q_lens, scale=None):
    """q: [C, Q_max, H, D]; int8 pages and float32 scales as
    ``paged_decode_attention_int8_plain``; block_tables [C, P];
    context_lens/q_lens [C] -> [C, Q_max, H, D], padded query rows 0."""
    return ragged_over_context(
        q, gather_dequant(k_pages, k_scales, block_tables),
        gather_dequant(v_pages, v_scales, block_tables), context_lens,
        q_lens, scale)


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
_RAGGED_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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
    _, page, h_kv, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.function("quantized_attention", "ptt_ragged_attention_int8",
                         _RAGGED_ARGS)
    _build.check(fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
                    _build.ptr(k_scales), _build.ptr(v_scales),
                    _build.ptr(block_tables), _build.ptr(context_lens),
                    _build.ptr(q_lens), _build.ptr(out), c, q_max, h, h_kv,
                    d, page, block_tables.shape[1],
                    tile_queries(q_max, h // h_kv), float(scale),
                    _build.dtype_code(q), _build.stream(q)), what)
    ragged_paged_attention_int8.launches += 1
    return out


ragged_paged_attention_int8.launches = 0
