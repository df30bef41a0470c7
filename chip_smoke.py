"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from paddle_tpu_torch/csrc (one nvcc per
source, all started together; each build's seconds printed), then:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, in bfloat16 and
   float32, with the kernel's, the plain version's and (where one PyTorch
   call computes the same function) the library call's time; the int8
   attention kernels read pages quantized by page_quant from random rows;
   the flash and ragged kernels take two routes by type and shape
   (flash_attention.route, ragged_attention.route): bfloat16 and float16
   the tensor-core kernels, held against the plain versions that round P
   and dS where they do (p_dtype; ragged: the kernel's own tiled walk,
   element by element) and against the float32 plain version (flash:
   beside the library call); float32 the SIMT kernels; ragged attention
   (float and int8 pages) at the smoke's mixed rows, with GQA 8, at
   contexts up to the engine's whole table ([long]), D = 64, a window of
   Q_max = 8 ([q8]), the verify windows of speculative decoding (4 rows of
   q_len 5 in s_pad 8 at serving contexts, [verify]), a 40-slot mixed step
   ([c40]) and float16, each printing its route; the flash backward at the training shape [4, 2048, 16, 128]
   and with GQA at [1, 2048, 32 -> 8, 128] in bfloat16, its dq, dk and dv
   each held; the edges of both routes in bfloat16 and float32 (S_q < S_k,
   S_q > S_k, S = 300, D = 64, GQA, the masked forms), float16 at one
   shape; flashmask forward and backward
   (a packed-document mask at [4, 2048, 16, 128], per-KV-head bounds under
   GQA, bidirectional 4 bounds, a window of 256; SDPA with the dense mask
   as the library time) and bias + dropout + residual + LayerNorm at
   BERT-base's [16384, 768] (its keep mask bit-equal to the plain
   Philox's); paged decode attention (float and int8 pages) at the
   smoke's contexts, at contexts up to the engine's whole table ([long]),
   with 16 query heads a KV head ([rep16]), the tiny model's D = 16 and the
   scalar path's D = 18, each with its split plan and CUDA launches per
   call; RMSNorm at the prefill, training, decode ([4, 4096]) and odd
   ([37, 333]) shapes; the RoPE kernel in each form the main path
   launches (q and k of the dense admission in one launch, with GQA 8;
   the paged steps' per-token rows, a decode step's and a ragged chunk's;
   q and k of the training step and their gradients, the transposed
   form), tables in x's type, and the scalar path (D = 18), each printing
   its path; GPT-3 1.3B's serving shapes (decode and ragged attention,
   float and int8 pages, at 16 KV heads of 128; the dense admission's
   causal flash at [4, 256, 16, 128]) and BERT-base's non-causal flash at
   [8, 512, 12, 64] beside SDPA; then the cost of the plain int8 page
   write (page_quant.write_rows) at the decode shape;
2. agree: a 2-layer tiny Llama in float32 with the same seeded weights on
   the CPU (plain versions) and on the card (kernels) — generate_batch
   with prefix cache, chunked prefill and mixed steps, generate_batch with
   cold prompts that fit the chunk (dense admission) beside a prefix hit,
   and generate with its KV cache must give the same greedy tokens; then
   the same two workloads and a fork mid-decode over int8 KV pages; then
   (agree:train) the first backward's gradients and 3 AdamW steps of
   compile_train_step must agree; (agree:masked) the tiny Llama with a
   padded-batch attn_mask (logits, loss, gradients), a tiny
   fused_feedforward and F.flashmask_attention in each bound form must
   agree; (agree:spec) speculative decoding on the tiny pair, float and
   int8 pools, with the n-gram drafter, self-drafting and a chunked-prefill
   interleave: CUDA spec-on tokens equal the CPU plain path's and (float)
   the spec-off tokens, float self-drafting accepts every draft;
   (surface) two threads streaming from one engine, a cancel, an
   export/import round trip through the CPU engine and a weight swap
   mid-run, each equal to the CPU plain path; (agree:graphs) the engine's
   step programs as replayed CUDA graphs against the eager twin
   (``_graphs = False``): greedy and seeded sampled tokens, float and int8
   pools, prefix sharing and chunked prefill, dense admission, a fork (the
   CoW copy program) and self-drafting must be token-identical with equal
   kernel launches, a repeat wave of the same shapes must build no
   program (the draft engine's too), and a weight swap in place must keep
   every program (a moved parameter drops them); (agree:gpt) the tiny
   GPT (multi-head, learned positions) through the prefix-sharing chunked
   workload, dense admissions and spec decoding (n-gram and draft model),
   float and int8 pools: CPU, CUDA graphs and the eager twin must give the
   same greedy tokens, and the card must launch decode, ragged and flash
   attention and the int8 twins; (agree:bert) the tiny BERT's three heads
   with and without a padding mask (and their losses), MultiHeadAttention
   through a Cache and a StaticCache, a Transformer, the six fused
   incubate layers, fused_multi_transformer and
   block_multihead_attention, CPU against the card within 1e-4 of each
   output's largest value, with the flash kernel launched once a layer
   where no mask is given and never under one; (agree:train2) each
   optimizer of the rest of training over 3 steps and LBFGS on a
   quadratic, AdamW under a warm-up cosine schedule on the tiny Llama,
   the tiny Llama with apply_llama_remat against itself without remat on
   the card (the forward kernels launched twice a layer), the tiny GPT's
   steps, a tiny BERT under amp O2 + GradScaler on the tensor-core flash
   route, and a checkpoint written from the card and loaded on the CPU
   bit for bit;
3. flashmask: F.flashmask_attention through autograd at [4, 2048, 16,
   128] bf16 with packed documents (each call must launch the masked
   forward and backward kernels once; out and grads held against the
   plain versions), then the forward at [1, 8192, 32, 128] beside SDPA
   with the dense mask; fused_ffn: BERT-base fused_feedforward (post-norm,
   gelu, dropout 0.1, training) forward and backward on [32, 512, 768]
   bf16 and the FusedBiasDropoutResidualLayerNorm layer, one bdrln launch
   a call;
4. serve: Llama-2-7B geometry in bfloat16 with random weights from a seed
   (all 32 layers) serves 8 requests of 300-900 tokens (chunked prefill,
   a prefix hit, mixed steps) through one engine whose step programs are
   CUDA graphs: a cold wave captures them, a warm wave of the same shapes
   (it must build none) gives the numbers, and a third wave runs engine
   steps 2-7 under torch.profiler (device time by kernel, idle share,
   host launch calls and device kernels per engine step); then the eager
   twin (``_graphs = False``) on a fresh engine, timed and profiled, must
   give the warm wave's tokens and kernel launches; every kernel of that
   path must launch, and a prefix-cache hit must occur;
5. serve:dense: the same model serves 8 cold requests of 64-256 tokens,
   which the engine admits through the dense prefill (flash attention and
   fused RoPE), a cold and a warm wave; then the first dense admission of
   a third wave (a replayed graph) runs under torch.profiler, and the
   eager twin must give the warm wave's tokens and launches;
6. serve:int8 and serve:dense:int8: the two workloads again with
   kv_dtype="int8" (int8 pools, the int8 attention kernels), each beside
   the share of its generated tokens that differ from its bf16 twin's
   (printed, not checked: the weights are random), then profiled as
   their twins are;
   then serve:spec and serve:spec:int8 (graphs, a cold and a warm wave
   each): the [serve] workload with self-drafting (DraftModelDrafter over
   the serving model, pools like the target's), then the n-gram drafter on
   prompts that hold their own next token (on random weights, text that
   merely repeats gives it nothing) beside their own spec-off run: the
   spec accounting, drafting and verify ms per dispatch, model steps and
   kernel launches per generated token beside the spec-off twin's, peak
   memory; both drafters must draft, no drafter error, float verify
   windows on the tensor-core ragged route, no float paged kernel in the
   int8 runs, and each request's first divergence from its spec-off twin
   a near-tie under the dense forward (SPEC_TIE_ULPS); then spec:rescore
   and spec:rescore:int8: self-drafting again, untimed, every dispatch
   with a rejected draft rescored through the plain ragged version with
   P in float32 and with P rounded as the kernel rounds it (rejections,
   flips against the kernel, and the decisions P's rounding alone
   changes);
   then serve:gpt, serve:gpt:int8 and serve:gpt:dense: with the Llama
   released, GPT-3 1.3B (all 24 layers, hidden 2048, 16 heads, FFN 8192,
   vocab 50304, bf16, random weights from seed 0) serves the serve and
   serve:dense workloads as the Llama does (cold, warm and profiled waves
   and the eager twins), launching decode and ragged or flash
   attention (int8 twins over int8 pools) and no RMSNorm, SwiGLU or RoPE;
   then bert: BERT-base's BertForMaskedLM in bf16 over 8 x 512 tokens
   without a mask (the non-causal flash kernel, 12 launches a forward) and
   with a padding mask (the dense path, none), agreeing on the unpadded
   row (one unmasked forward profiled), and FusedMultiTransformer at the
   same widths (12 layers), each with its ms per forward;
7. train: with the serving models released, the configuration bench.py
   trains on the TPU (0.74B Llama, batch 4 x 2048, bf16 parameters,
   AdamW(1e-4, multi_precision=True)) takes a warm-up step and 5 timed
   steps of compile_train_step on random weights and a fixed batch: the
   losses must be finite and fall, and every step must launch each kernel
   of the path as often as the model has call sites; then (profile:train)
   one more step under torch.profiler; then train:remat (bench.py:147-170
   exactly: the same model with recompute=True and apply_llama_remat: the
   losses equal to train's, the forward kernels twice a layer, peak memory
   below train's, MFU of the model's flops beside the hardware's, one
   step profiled and its device kernels held to the counted launches),
   train:gpt (GPT-3 1.3B, all 24 layers, 4 x 2048, AdamW with masters
   under a warm-up cosine schedule: 24 + 24 flash launches a step, the
   rate each step the scheduler's) and train:bert (BERT-base MLM 32 x 512
   under amp O2 + GradScaler with dropout 0.1: the dense attention path,
   the scale after each step).

Each flashmask, fused_ffn, serving, BERT and training run's launch counts are
set to 0 just before it and read just after it; every kernel of its path
must have launched, the int8 runs must launch the float paged attention
kernels 0 times, every flash launch of the training, dense-serving and
flashmask runs (bfloat16) and every ragged launch of the serving runs must
take the tensor-core route; every model step of the Llama serving runs
must launch RoPE once a layer (q and k together, on the vector path), and
every training step once a layer each way. Then
it prints the card's name and power limit, one JSON line with every
kernel's numbers, and as the last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero without that line. Without a CUDA card
it exits 2 before doing anything. The serving runs also print decode
attention's launches per decode step and, profiled, its share and the
ragged kernel's share of the device's busy time.

--parent DIR names a copy of an earlier commit's paddle_tpu_torch/csrc
(for example `git archive HEAD~1 paddle_tpu_torch/csrc | tar -x -C
build/parent_src`): its decode attention, ragged attention (float and
int8 pages), RMSNorm and RoPE are built beside this tree's and timed on
the same inputs in the order parent, kernel, kernel, parent (parent_ms on
the [kernels] rows; a q + k RoPE row times the parent's kernel on q and
on k, the per-token rows and the backward the plain versions that the
parent's tree ran there).
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor-core bf16; fp32 non-tensor
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# the bf16 flash backward, element by element: |got - want| <=
# 2^-7 |want| (one bf16 rounding of either side) + 2^-8 rms(want)
BWD_REL_BF16, BWD_FLOOR_BF16 = 2.0 ** -7, 2.0 ** -8
# the 16-bit (tensor-core) flash backward: at most max(ceil(this share of
# the elements), BWD_OVER_FLOOR) elements of each of dq, dk and dv beyond
# that rule, every element within it plus one rounding of each term of its
# product (see _within)
BWD_OVER_SHARE = 1e-5
BWD_OVER_FLOOR = 4
# a 16-bit kernel's error against the float32 plain version, at most this
# multiple of the library call's
LIB_ERR_FACTOR = 2.0
ITERS = 20                          # timed launches per kernel
L2_FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2
# device clock cycles (~1 ms) the stream spins before each timed launch
HEAD_START_CYCLES = 2_000_000
_flush = []


def _time_ms(fn, iters=ITERS):
    """Mean device time of fn over `iters` launches, each timed alone
    after a read of a buffer larger than L2, so that every launch reads
    its inputs from HBM as the bound assumes. The stream then spins for
    ~1 ms, so that the host has enqueued the start event and fn's kernels
    before the device reaches them: a slow host adds no gap to the
    measured span."""
    if not _flush:
        _flush.append(torch.empty(L2_FLUSH_BYTES // 4, device="cuda"))
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _flush[0].sum()
        torch.cuda._sleep(HEAD_START_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _ulp_bf16(ref):
    """One bf16 ulp at each element of ref (float32 tensor)."""
    e = torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


# ----------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ----------------------------------------------------------------------

def _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max):
    """Page pools holding each row's context at shuffled page ids (page 0
    is the trash page, filled with garbage). rows: list of (ctx, q_len,
    dummy). Returns (k_pages, v_pages, block_tables int32 [C, P])."""
    need = [0 if dummy else -(-ctx // page) for ctx, _, dummy in rows]
    n_pages = 1 + sum(need)
    ids = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(rows), p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        bt[i, :n] = ids[at:at + n]
        at += n
    k = torch.from_numpy(rng.standard_normal(
        (n_pages, page, h_kv, d), dtype=np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal(
        (n_pages, page, h_kv, d), dtype=np.float32)).to(dev, dtype)
    return k, v, torch.from_numpy(bt).to(dev)


def _int8_pools(kp, vp):
    """Float pools -> (int8 codes and float32 scale rows) for K and V:
    page_quant's whole-page quantization, scales from the data."""
    from paddle_tpu_torch.quantization import page_quant
    kq, ks = page_quant.quantize_pages(kp)
    vq, vs = page_quant.quantize_pages(vp)
    return (kq, vq, ks, vs)


# the smoke's ragged rows (Llama-2-7B heads, the engine's table of 256
# pages of 16): a suffix chunk after a 300-token prefix, a first chunk
# ending mid-page, a decode row, a dummy row; (context, q_len, dummy)
RAGGED_ROWS = ((556, 256, False), (200, 200, False), (777, 1, False),
               (1, 1, True))
# [long]: a 256-query chunk at the tail of a 4096-token context (the whole
# table), decode rows at 3000 and 2048, a dummy row
RAGGED_LONG = ((4096, 256, False), (3000, 1, False), (2048, 1, False),
               (1, 1, True))
# [q8]: a short suffix or verify window (Q_max 8), contexts mid-page
RAGGED_Q8 = ((37, 8, False), (21, 5, False), (90, 1, False), (1, 1, True))
# [verify]: a speculative verify dispatch of the [serve:spec] runs: 4 rows
# of q_len 5 (the last committed token and 4 drafts) in s_pad 8, at the
# serving contexts (prompts of 300-900 tokens plus what has been generated)
RAGGED_VERIFY = ((617, 5, False), (349, 5, False), (905, 5, False),
                 (448, 5, False))
# [c40]: a mixed step at 40 slots (tables of 64 pages): four chunks of up
# to 256 queries, 35 decode rows, a dummy row; at GQA 8 a block holds 32
# positions, so 40 x 8 = 320 (row, query tile) items, past the 256 that
# the kernel's blocks rank by keys (its fixed order: last query tile first)
RAGGED_C40 = ((600, 256, False), (256, 256, False), (900, 200, False),
              (333, 77, False)) + tuple(
                  (17 + 29 * i, 1, False) for i in range(35)) + \
    ((1, 1, True),)


def _row_rule(got, want, extra=None):
    """Largest err / (2^-7 |want| + 2^-8 rms of want's row over D [+ extra])
    over the elements of a [C, Q, H, D] output (the flash backward's form,
    with the rms of each (row, query, head)); an element allowed 0 passes
    only when it is exact."""
    want = want.float()
    err = (got.float() - want).abs()
    allow = BWD_REL_BF16 * want.abs() + \
        BWD_FLOOR_BF16 * want.square().mean(-1, keepdim=True).sqrt()
    if extra is not None:
        allow = allow + extra
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return float(ratio.max())


def check_ragged(K, dev, dtype, h_kv, rng, int8=False, rows=RAGGED_ROWS,
                 q_max=256, h=32, d=128, page=16, p_max=256):
    """Ragged paged attention against its plain versions. The tensor-core
    route (16-bit q, D 64/128, pages of a multiple of 8) rounds P (int8: P
    times the key's V multiplier) to q's type before the P V product: each
    element is held to 2^-7 |want| + 2^-8 rms(want's row) against the
    kernel's own walk (``*_tiled_plain`` with p_dtype: the same tiles, the
    same rounding points), and to that plus half an ulp of each rounded P
    term (half_ulp * sum_k w_k |V_k|, from the plain version over |V|)
    against the float32-P plain version (the TPU kernel's rounding). The
    same walk with the last 64 keys of the longest decode row dropped must
    fail the first rule. The SIMT route keeps P float32 and is held to TOL.
    With the parent's build loaded, its ragged entry is timed beside the
    kernel (parent, kernel, kernel, parent)."""
    from paddle_tpu_torch.ops.kernels import ragged_attention as RA
    c = len(rows)
    kp, vp, bt = _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max)
    ctx = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal(
        (c, q_max, h, d), dtype=np.float32)).to(dev, dtype)
    if int8:
        fn, plain, tiled = K.ragged_paged_attention_int8, \
            K.ragged_paged_attention_int8_plain, \
            K.ragged_paged_attention_int8_tiled_plain
    else:
        fn, plain, tiled = K.ragged_paged_attention, \
            K.ragged_paged_attention_plain, \
            K.ragged_paged_attention_tiled_plain
    name = fn.__name__
    pools = _int8_pools(kp, vp) if int8 else (kp, vp)
    rt = RA.route(q, page)
    before = getattr(fn, f"{rt}_launches")
    got = fn(q, *pools, bt, ctx, ql)
    if getattr(fn, f"{rt}_launches") != before + 1:
        raise AssertionError(f"{name}: the launch took no {rt} route")
    pd = dtype if rt == "sm90" else None
    want = tiled(q, *pools, bt, ctx, ql, p_dtype=pd) if pd is not None \
        else plain(q, *pools, bt, ctx, ql)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    pad_zero = all(float(got[i, n:].float().abs().max()) == 0.0
                   for i, (_, n, _) in enumerate(rows) if n < q_max)
    if not pad_zero:
        raise AssertionError("ragged: padded query rows are not zero")
    elt = q.element_size()
    kv_elt = pools[0].element_size()
    pairs = sum(sum(min(ctx_r - n + i + 1, ctx_r) for i in range(n))
                for ctx_r, n, _ in rows)
    flops = 4 * pairs * h * d
    # q is read for the real queries only; the output is written whole
    # (padded rows as zeros); each row's K and V are read up to its context
    # (int8: plus one float32 K and V scale per page read)
    nbytes = (sum(r[1] for r in rows) * h * d * elt + q.numel() * elt
              + 2 * sum(r[0] for r in rows) * h_kv * d * kv_elt)
    if int8:
        nbytes += 2 * 4 * sum(-(-r[0] // page) for r in rows)
    res = {"got": got, "want": want, "err": err, "route": rt, "flops": flops,
           "bytes": nbytes,
           "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx, ql,
                                              p_dtype=pd), ITERS // 10),
           "library_ms": None}
    if pd is not None:
        res["tiled"] = _row_rule(got, want)
        # per batch row: the largest error and the rms of its real outputs
        res["rows"] = [(_max_err(got[i, :n], want[i, :n]),
                        float(want[i, :n].float().square().mean().sqrt()))
                       for i, (_, n, _) in enumerate(rows)]
        f32p = plain(q, *pools, bt, ctx, ql)
        vabs = (pools[0], pools[1].abs(), *pools[2:]) if int8 else \
            (pools[0], pools[1].abs())
        half_ulp = torch.finfo(dtype).eps / 2
        terms = plain(q, *vabs, bt, ctx, ql).float() * half_ulp
        res["err_f32p"] = _max_err(got, f32p)
        res["f32p"] = _row_rule(got, f32p, terms)
        del f32p, terms
        # a kernel that drops a key tile: the longest decode row (with no
        # decode row, the longest row) without its last 64 keys (its
        # queries then sit 64 positions earlier)
        real = [i for i, (n_ctx, _, dummy) in enumerate(rows)
                if not dummy and n_ctx > 64]
        dec = max([i for i in real if rows[i][1] == 1] or real,
                  key=lambda i: rows[i][0])
        short = ctx.clone()
        short[dec] -= 64
        res["dropped"] = _row_rule(tiled(q, *pools, bt, short, ql,
                                         p_dtype=pd), want)
        if res["dropped"] <= 1.0:
            raise AssertionError(f"{name}: the 16-bit rule does not reject "
                                 f"a dropped key tile")
    res.update(_with_parent(
        lambda: fn(q, *pools, bt, ctx, ql),
        lambda: _parent_ragged(int8, q, pools, bt, ctx, ql),
        "quantized_attention" if int8 else "ragged_attention", want))
    if "parent_ms" in res:
        res["parent_route"] = "sm90" if pd is not None and \
            "ragged_sm90" in _PARENT else "simt"
    return res


# the smoke's decode batch (Llama-2-7B heads at B = 4, the engine's table
# of 256 pages of 16) and the long one, where the bound (~0.045 ms in bf16)
# rather than launch latency sets the floor
DECODE_LENS = (1000, 517, 64, 1)
LONG_LENS = (4096, 3000, 2048, 1)


def check_decode(K, dev, dtype, rng, h_kv=32, int8=False, lens=DECODE_LENS,
                 b=4, h=32, d=128, page=16, p_max=256):
    """The decode kernel against its plain version; the record carries the
    split plan (from shapes alone) and the CUDA launches of one call (the
    split kernel, and the merge when the plan has more than one split)."""
    rows = [(n, 1, False) for n in lens]
    kp, vp, bt = _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal(
        (b, h, d), dtype=np.float32)).to(dev, dtype)
    if int8:
        fn, plain = K.paged_decode_attention_int8, \
            K.paged_decode_attention_int8_plain
    else:
        fn, plain = K.paged_decode_attention, K.paged_decode_attention_plain
    pools = _int8_pools(kp, vp) if int8 else (kp, vp)
    got = fn(q, *pools, bt, ctx)
    want = plain(q, *pools, bt, ctx)
    torch.cuda.synchronize()
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + \
        2 * sum(lens) * h_kv * d * pools[0].element_size()
    if int8:                  # one float32 K and V scale per page read
        nbytes += 2 * 4 * sum(-(-n // page) for n in lens)
    splits, pps = K.split_plan(b, h, h_kv, p_max, page)
    res = {"got": got, "want": want, "err": _max_err(got, want),
           "flops": 4 * sum(lens) * h * d, "bytes": nbytes,
           "plan": (splits, pps), "launches_per_call": 1 + (splits > 1),
           "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx),
                                ITERS // 10),
           "library_ms": None}
    name = "quantized_attention" if int8 else "decode_attention"
    res.update(_with_parent(lambda: fn(q, *pools, bt, ctx),
                            lambda: _parent_decode(name, q, pools, bt, ctx),
                            name, want))
    return res


def check_rms(K, dev, dtype, rng, t=1024, hid=4096):
    eps = 1e-6
    x = torch.from_numpy(rng.standard_normal(
        (t, hid), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
        hid, dtype=np.float32)).to(dev, dtype)
    got = K.rms_norm(x, w, eps)
    want = K.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    elt = x.element_size()
    res = {"got": got, "want": want, "err": _max_err(got, want),
           "flops": 4 * x.numel(),
           "bytes": 2 * x.numel() * elt + hid * w.element_size(),
           "plain_ms": _time_ms(lambda: K.rms_norm_plain(x, w, eps)),
           "library_ms": _time_ms(lambda: torch.nn.functional.rms_norm(
               x, (hid,), w, eps))}
    res.update(_with_parent(lambda: K.rms_norm(x, w, eps),
                            lambda: _parent_rms(x, w, eps), "rms_norm",
                            want))
    return res


# ----------------------------------------------------------------------
# the parent commit's versions of the kernels this tree redesigned, timed
# beside them in the same call (python3 chip_smoke.py --parent DIR)
# ----------------------------------------------------------------------

PARENT_SOURCES = ("decode_attention", "quantized_attention", "rms_norm",
                  "ragged_attention", "ragged_sm90", "rope")
_PARENT = {}             # source name -> ctypes library of the parent's build


def _start_parent(src_dir):
    """One nvcc per parent source in src_dir (a copy of the parent's
    paddle_tpu_torch/csrc), into build/parent/, with the port's flags."""
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build
    out = Path(__file__).resolve().parent / "build" / "parent"
    out.mkdir(parents=True, exist_ok=True)
    src_dir = Path(src_dir).resolve()
    # a parent older than a source (ragged_sm90 is younger than decode or
    # RMSNorm) lacks it
    return {name: (out / f"lib{name}.so", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(out / f"lib{name}.so"), str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in PARENT_SOURCES if (src_dir / f"{name}.cu").exists()}


def _finish_parent(jobs):
    import ctypes
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log[-3000:]}")
        for kernel, used in _ptxas_kernels(log):
            print(f"[ptxas:parent] {name}: {kernel}: {used}")
        _PARENT[name] = ctypes.CDLL(str(lib))


def _parent_decode(name, q, pools, bt, ctx):
    """The parent's decode entry on these inputs (the split-K entry of this
    tree's signature: a workspace sized by the same split plan)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import quantized_attention as QA
    int8 = name == "quantized_attention"
    fn = getattr(_PARENT[name], "ptt_decode_attention_int8" if int8
                 else "ptt_decode_attention")
    fn.argtypes = QA._DECODE_ARGS if int8 else DA._ARGS
    fn.restype = ctypes.c_int
    b, h, d = q.shape
    _, page, h_kv, _ = pools[0].shape
    out = torch.empty_like(q)
    ws = DA.workspace(q, DA.split_plan(b, h, h_kv, bt.shape[1], page)[0])
    _build.check(fn(*[_build.ptr(t) for t in (q, *pools, bt, ctx, out)],
                    _build.ptr_or_null(ws), b, h, h_kv, d, page, bt.shape[1],
                    1.0 / math.sqrt(d), _build.dtype_code(q),
                    _build.stream(q)), f"parent {name}")
    return out


def _parent_ragged(int8, q, pools, bt, ctx, ql):
    """The parent's ragged entry on these inputs, float or int8 pages: its
    tensor-core kernel where it has one (ragged_sm90) and the tree's route
    takes it, else its SIMT kernel."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import quantized_attention as QA
    from paddle_tpu_torch.ops.kernels import ragged_attention as RA
    c, q_max, h, d = q.shape
    n, page, h_kv, _ = pools[0].shape
    sm90 = "ragged_sm90" in _PARENT and RA.route(q, page) == "sm90"
    lib = _PARENT["ragged_sm90"] if sm90 else \
        _PARENT["quantized_attention" if int8 else "ragged_attention"]
    fn = getattr(lib, "ptt_ragged_attention" + ("_int8" if int8 else "")
                 + ("_sm90" if sm90 else ""))
    fn.argtypes = QA._RAGGED_ARGS if int8 else RA._ARGS
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    _build.check(fn(*[_build.ptr(t) for t in (q, *pools, bt, ctx, ql, out)],
                    c, q_max, h, h_kv, d, page, bt.shape[1],
                    n if sm90 else RA.tile_queries(q_max, h // h_kv),
                    1.0 / math.sqrt(d), _build.dtype_code(q),
                    _build.stream(q)), "parent ragged attention")
    return out


def _parent_rms(x, w, eps):
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.rms_norm import _ARGS
    fn = _PARENT["rms_norm"].ptt_rms_norm
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    h = x.shape[-1]
    out = torch.empty_like(x)
    _build.check(fn(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                    x.numel() // h, h, float(eps), _build.dtype_code(x),
                    _build.dtype_code(w), _build.stream(x)), "parent rms_norm")
    return out


def _parent_rope(x, cos, sin):
    """The parent's RoPE entry (one tensor, [S, D] tables) on x: its
    ``ptt_rope`` (the tree's signature) or, in older parents,
    ``ptt_fused_rope``."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import rope as RP
    b, s, h, d = x.shape
    out = torch.empty_like(x)
    lib = _PARENT["rope"]
    if hasattr(lib, "ptt_rope"):
        fn = lib.ptt_rope
        fn.argtypes, fn.restype = RP._ARGS, ctypes.c_int
        null, vec = ctypes.c_void_p(None), ctypes.c_int(0)
        _build.check(fn(_build.ptr(x), null, _build.ptr(out), null,
                        _build.ptr(cos), _build.ptr(sin), b * s, s, h, 0, d,
                        0, 0, _build.dtype_code(x), _build.dtype_code(cos),
                        ctypes.byref(vec), _build.stream(x)), "parent rope")
        return out
    fn = lib.ptt_fused_rope
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(_build.ptr(x), _build.ptr(cos), _build.ptr(sin),
                    _build.ptr(out), b * s * h, s, h, d, _build.dtype_code(x),
                    _build.dtype_code(cos), _build.stream(x)), "parent rope")
    return out


def _flat(out):
    """A result or a tuple of results as one flat tensor."""
    if isinstance(out, tuple):
        return torch.cat([t.flatten() for t in out])
    return out


def _with_parent(run, parent, name, want):
    """{"ms": the kernel's time} -- with the parent's build loaded, both
    timed in the order parent, kernel, kernel, parent (each the mean of
    the two), plus the parent's time and its error against the plain
    version (printed, not held: the parent is not under test)."""
    if name not in _PARENT:
        return {"ms": _time_ms(run)}
    err = _max_err(_flat(parent()), want)
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (_time_ms(f) for f in (parent, run, run, parent))
    return {"ms": (k1 + k2) / 2, "parent_ms": (p1 + p2) / 2,
            "parent_abba": (p1, k1, k2, p2), "parent_err": err}


def check_swiglu(K, dev, dtype, rng, t=1024, f=11008):
    g = torch.from_numpy(rng.standard_normal(
        (t, f), dtype=np.float32)).to(dev, dtype)
    u = torch.from_numpy(rng.standard_normal(
        (t, f), dtype=np.float32)).to(dev, dtype)
    got = K.swiglu(g, u)
    want = K.swiglu_plain(g, u)
    torch.cuda.synchronize()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 5 * g.numel(), "bytes": 3 * g.numel() * g.element_size(),
            "ms": _time_ms(lambda: K.swiglu(g, u)),
            "plain_ms": _time_ms(lambda: K.swiglu_plain(g, u)),
            "library_ms": None}


def _causal_pairs(s_q, s_k):
    """Visible (query, key) pairs of one head under the bottom-right
    causal mask."""
    off = s_k - s_q
    return sum(max(0, min(i + off + 1, s_k)) for i in range(s_q))


def _p_dtype(dtype):
    """The rounding of P and dS in the flash kernel of this type: the
    tensor-core kernels (16-bit inputs) round them to the input type where
    the TPU kernel does; the float32 SIMT kernels keep them float32."""
    return None if dtype == torch.float32 else dtype


def _sdpa(q, k, v, causal, dense=None):
    """PyTorch's scaled_dot_product_attention on [B, H, S, D] views of
    paddle-layout tensors: is_causal where S_q = S_k and no mask is given,
    else a dense bool mask (bottom-right causal when none is given)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s_q, s_k = q.shape[1], k.shape[1]
    gqa = q.shape[2] != k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if dense is None and causal and s_q != s_k:
        dense = torch.ones(s_q, s_k, dtype=torch.bool,
                           device=q.device).tril(s_k - s_q)
    if dense is None:
        return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    return sdpa(qt, kt, vt, attn_mask=dense, enable_gqa=gqa)


def _accuracy_fwd(K, q, k, v, got, causal, bounds=None, dense=None):
    """(kernel's, library's) largest error against the float32 plain
    version on float32 copies of the inputs, over the rows that see a key
    (SDPA gives NaN where a row sees none)."""
    want, lse = K.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                            causal, None, bounds)
    seen = (lse > -1e29).transpose(1, 2)[..., None]
    lib = _sdpa(q, k, v, causal, dense).transpose(1, 2)

    def err(a):
        return float(torch.where(seen, (a.float() - want).abs(), 0.0).max())
    return err(got), err(lib)


def _accuracy_bwd(K, q, k, v, do, got, causal, bounds=None, dense=None,
                  library=True):
    """(kernel's, library's) largest errors of dq, dk, dv against the
    float32 plain backward on float32 copies of the inputs (out and lse
    from the float32 plain forward). The library's gradients: SDPA's
    backward under autograd after its own forward (None without a
    library)."""
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = K.flash_attention_fwd_plain(*f[:3], causal, None, bounds)
    want = K.flash_attention_bwd_plain(*f[:3], out32, lse32, f[3], causal,
                                       None, bounds)
    del out32, lse32, f
    kerr = [_max_err(a, r) for a, r in zip(got, want)]
    lerr = None
    if library:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = _sdpa(*leaves, causal, dense)
        grads = torch.autograd.grad(o, leaves, do.transpose(1, 2))
        lerr = [_max_err(g, r) for g, r in zip(grads, want)]
    return kerr, lerr


def check_flash(K, dev, dtype, rng, b, s_q, s_k, h, h_kv, d=128,
                library=True, causal=True):
    """Flash attention (causal unless told otherwise) against its plain
    version, rounding P where the kernel of this type does. The library call is PyTorch's
    scaled_dot_product_attention on [B, H, S, D] views (its causal mask is
    top-left aligned, so it is timed only where S_q = S_k; its accuracy,
    beside the kernel's, against the float32 plain version, is taken with
    a bottom-right bool mask where S_q != S_k)."""
    q = torch.from_numpy(rng.standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    got, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    pd = _p_dtype(dtype)
    want, want_lse = K.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 p_dtype=pd)
    torch.cuda.synchronize()
    blind = max(0, s_q - s_k) if causal else 0   # rows that see no key
    if blind and float(got[:, :blind].float().abs().max()) != 0.0:
        raise AssertionError("flash: rows with no visible key are not 0")
    finite = want_lse > -1e29
    lse_err = float((lse - want_lse)[finite].abs().max())
    if lse_err > 1e-3 or not bool((lse[~finite] <= -1e29).all()):
        raise AssertionError(f"flash: lse disagrees with the plain version "
                             f"(max abs err {lse_err})")
    acc = None if pd is None else _accuracy_fwd(K, q, k, v, got, causal)
    elt = q.element_size()
    lib = None
    if library and (s_q == s_k or not causal):
        lib = _time_ms(lambda: _sdpa(q, k, v, causal))
    pairs = _causal_pairs(s_q, s_k) if causal else s_q * s_k
    return {"got": got, "want": want, "err": _max_err(got, want),
            "lse_err": lse_err, "acc": acc,
            "flops": 4 * b * h * d * pairs,
            "bytes": (2 * q.numel() + 2 * k.numel()) * elt + lse.numel() * 4,
            "ms": _time_ms(lambda: K.flash_attention_fwd(q, k, v,
                                                         causal=causal)),
            "plain_ms": _time_ms(lambda: K.flash_attention_fwd_plain(
                q, k, v, causal=causal, p_dtype=pd), ITERS // 10),
            "library_ms": lib}


def _rounding_terms(K, q, k, v, out, lse, do, causal, bounds=None):
    """For each element of dq, dk and dv, the sum of the absolute terms of
    the product the 16-bit kernels take it from, over the operand they
    round: scale |dS| |K|, scale |dS|^T |Q| and P^T |dO| (float32, the
    plain backward's P and dS)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import _visible
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s_q, h_kv, rep, d).float()
    dog = do.reshape(b, s_q, h_kv, rep, d).float()
    delta = (dog * out.reshape(b, s_q, h_kv, rep, d).float()).sum(-1)
    p = torch.exp(torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale -
                  lse.reshape(b, h_kv, rep, s_q, 1))
    vis = _visible(b, s_q, s_k, h_kv, rep, causal, bounds, q.device)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    ds = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = (p * (ds - delta.permute(0, 2, 3, 1)[..., None])).abs_()
    tq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float().abs()) * scale
    tk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg.abs()) * scale
    del ds
    tv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog.abs())
    return tq.reshape(b, s_q, h, d), tk, tv


def check_flash_bwd(K, dev, dtype, rng, b, s_q, s_k, h, h_kv, d=128,
                    library=True):
    """The causal flash backward against its plain version (rounding P and
    dS where the kernel of this type does) on the same q, k, v, dout and
    the forward kernel's out and lse. The library call is PyTorch's
    backward of the same function: aten's flash attention backward
    (aten._scaled_dot_product_flash_attention_backward, on [B, H, S, D]
    views, after its own forward) where S_q = S_k without GQA, SDPA's
    backward with enable_gqa under autograd under GQA; a yardstick the
    port never calls."""
    q, do = (torch.from_numpy(rng.standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
        for _ in range(2))
    out, lse = K.flash_attention_fwd(q, k, v, causal=True)
    got = K.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    pd = _p_dtype(dtype)
    want = K.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                       p_dtype=pd)
    torch.cuda.synchronize()
    terms = None if pd is None else _rounding_terms(K, q, k, v, out, lse, do,
                                                    True)
    res = _grad_rule(got, want, terms)
    if terms is not None:
        # the rule must reject a kernel wrong by one typical value on a
        # tail of keys (one rms added to dk's last 10% of keys) or of
        # queries (to dq's last 10%)
        for i, what, s_x in ((1, "dk", s_k), (0, "dq", s_q)):
            bad = list(got)
            bad[i] = got[i].float()
            bad[i][:, -max(1, s_x // 10):] += res["rms"][i]
            tail = _grad_rule(bad, want, terms)
            passed, _ = _within("flash_attention_bwd", tail, dtype)
            print(f"[kernels] flash_attention_bwd rule on {what} with one "
                  f"rms added to its last 10% of "
                  f"{'keys' if i else 'queries'}: elements beyond "
                  f"{tail['over_n'][i]} (allowed "
                  f"{_over_allowed(tail['n'][i])}), err/bound "
                  f"{tail['bound'][i]:.1f} (must fail)", flush=True)
            if passed:
                raise AssertionError(f"flash_attention_bwd: the 16-bit rule "
                                     f"does not reject a wrong tail of "
                                     f"{what}")
            del bad, tail
    del terms
    # the library: aten's flash backward where it applies, else SDPA's
    # (blind rows give NaN in SDPA: no library there)
    acc = None
    if pd is not None:
        acc = _accuracy_bwd(K, q, k, v, do, got, True,
                            library=s_q <= s_k)
    elt = q.element_size()
    lib = None
    if library:
        lib = _library_flash_bwd(q, k, v, do)
    res.update({
        "got": got, "want": want, "acc": acc,
        # five products over the visible pairs: S, dP, dV, dQ, dK
        "flops": 10 * b * h * d * _causal_pairs(s_q, s_k),
        # q, out, dout and k, v read, lse read, dq, dk, dv written
        "bytes": (4 * q.numel() + 4 * k.numel()) * elt + lse.numel() * 4,
        "ms": _time_ms(lambda: K.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True)),
        "plain_ms": _time_ms(lambda: K.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal=True, p_dtype=pd), ITERS // 10),
        "library_ms": lib})
    return res


def _library_flash_bwd(q, k, v, do):
    """ms of PyTorch's backward of causal attention at this shape: aten's
    flash attention backward without GQA, SDPA's backward with enable_gqa
    under autograd with it; None (printed) when this PyTorch build refuses
    the call."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    try:
        if q.shape[2] != k.shape[2]:
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            o = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True)
            return _time_ms(lambda: torch.autograd.grad(
                o, leaves, dot, retain_graph=True))
        fw = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)
        bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        args = (dot, qt, kt, vt, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5],
                0.0, True, fw[6], fw[7])
        return _time_ms(lambda: bwd(*args))
    except (RuntimeError, TypeError) as e:
        print(f"[kernels] library flash backward not timed: "
              f"{type(e).__name__}: {str(e)[:200]}")
        return None


def _flashmask_case(rng, dev, b, s, h, h_kv, form):
    """Bounds of one flashmask form at [B, S] (query length = key length):
    "doc" packs documents of seeded lengths 64-1024 into each row, causal
    with start[t] = the end of t's document (1 bound, one row for all
    heads); "gqa" per-KV-head causal 2-bound intervals [start, end) below
    the diagonal; "bidir" per-head bidirectional 4 bounds; "window" causal
    window_size=256 through F._window_to_indices. Returns (causal, bounds
    (start, end, start2, end2) as the kernel takes them, the dense bool
    mask [B, kh or H, S, S] (True = attend, for SDPA), visible pairs)."""
    from paddle_tpu_torch.nn import functional as F

    col = np.arange(s)
    if form == "doc":
        causal, kh = True, 1
        start = np.empty((b, 1, s), np.int64)
        for i in range(b):
            pos = 0
            while pos < s:
                end = min(s, pos + int(rng.integers(64, 1025)))
                start[i, 0, pos:end] = end
                pos = end
        idx = start[..., None]
    elif form == "gqa":
        causal, kh = True, h_kv
        st = np.minimum(s, col + rng.integers(1, 513, (b, kh, s)))
        en = np.minimum(s, st + rng.integers(0, 1025, (b, kh, s)))
        idx = np.stack([st, en], -1)
    elif form == "bidir":
        causal, kh = False, h
        shp = (b, kh, s)
        lts = np.maximum(rng.integers(1, s + 1, shp), col + 1)
        lte = np.minimum(lts + rng.integers(0, s // 2, shp), s)
        ute = np.minimum(rng.integers(0, s, shp), col)
        uts = np.maximum(ute - rng.integers(0, s // 2, shp), 0)
        idx = np.stack([lts, lte, uts, ute], -1)
    else:
        causal = True
        idx = F._window_to_indices(256, b, s, s, True, "cpu").numpy()
        kh = 1
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    bounds = tuple(None if t is None else t.contiguous()
                   for t in F._flashmask_intervals(idx, causal, s))
    rows = torch.arange(s, device=dev)[None, None, :, None]
    ms, me, ms2, me2 = bounds
    masked = (ms[:, :, None, :] <= rows) & (rows < me[:, :, None, :])
    if ms2 is not None:
        masked |= (ms2[:, :, None, :] <= rows) & (rows < me2[:, :, None, :])
    dense = ~masked
    del masked
    if causal:
        dense &= torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    if kh == h_kv and h_kv != h:
        dense = dense.repeat_interleave(h // h_kv, dim=1)
    pairs = int(dense.sum()) * (h // dense.shape[1])
    return causal, bounds, dense, pairs


def _bounds_bytes(bounds):
    return sum(t.numel() * 4 for t in bounds if t is not None)


def check_flashmask(K, dev, dtype, rng, b, s, h, h_kv, form, d=128,
                    library=True):
    """The masked flash forward against its plain version; the library
    call is SDPA with the dense boolean mask (built outside the timed
    region; a yardstick the port never calls)."""
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h_kv,
                                                   form)
    q = torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h_kv, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    got, lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=causal)
    pd = _p_dtype(dtype)
    want, want_lse = K.flashmask_attention_fwd_plain(q, k, v, *bounds,
                                                     causal=causal,
                                                     p_dtype=pd)
    torch.cuda.synchronize()
    acc = None if pd is None else _accuracy_fwd(K, q, k, v, got, causal,
                                                bounds, dense)
    seen = want_lse > -1e29
    lse_err = float((lse - want_lse)[seen].abs().max())
    if lse_err > 1e-3 or not bool((lse[~seen] <= -1e29).all()):
        raise AssertionError(f"flashmask {form}: lse disagrees with the "
                             f"plain version (max abs err {lse_err})")
    elt = q.element_size()
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense,
                                    enable_gqa=h != h_kv))
    del dense
    return {"got": got, "want": want, "err": _max_err(got, want),
            "lse_err": lse_err, "pairs": pairs, "acc": acc,
            "flops": 4 * d * pairs,
            "bytes": (2 * q.numel() + 2 * k.numel()) * elt +
            lse.numel() * 4 + _bounds_bytes(bounds),
            "ms": _time_ms(lambda: K.flashmask_attention_fwd(
                q, k, v, *bounds, causal=causal)),
            "plain_ms": _time_ms(lambda: K.flashmask_attention_fwd_plain(
                q, k, v, *bounds, causal=causal, p_dtype=pd), ITERS // 10),
            "library_ms": lib}


def _grad_rule(got, want, terms=None):
    """The flash backward's checks over (dq, dk, dv): max errors, largest
    values, mean, rms and the worst err / (2^-7 |want| + 2^-8 rms(want));
    with the rounded products' absolute term sums (``_rounding_terms``),
    also the share of elements beyond that allowance and the worst err /
    (the allowance + 2^-7 terms)."""
    out = {"errs": [], "scales": [], "means": [], "rms": [], "worst": [],
           "over": [], "over_n": [], "n": [], "bound": []}
    for i, (a, r) in enumerate(zip(got, want)):
        r = r.float()
        rms = float(r.square().mean().sqrt())
        allow = BWD_REL_BF16 * r.abs() + BWD_FLOOR_BF16 * rms
        err = (a.float() - r).abs()
        out["errs"].append(float(err.max()))
        out["scales"].append(float(r.abs().max()))
        out["means"].append(float(r.abs().mean()))
        out["rms"].append(rms)
        out["worst"].append(float((err / allow).max()))
        if terms is not None:
            over_n = int((err > allow).sum())
            out["over_n"].append(over_n)
            out["n"].append(err.numel())
            out["over"].append(over_n / err.numel())
            out["bound"].append(float(
                (err / (allow + BWD_REL_BF16 * terms[i].float())).max()))
    out["err"] = max(out["errs"])
    return out


def check_flashmask_bwd(K, dev, dtype, rng, b, s, h, h_kv, form, d=128,
                        library=True):
    """The masked flash backward against its plain version on the same q,
    k, v, dout, bounds and the forward kernel's out and lse. The library
    call is the backward alone of SDPA with the dense boolean mask
    (autograd.grad after one forward, retain_graph)."""
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h_kv,
                                                   form)
    q, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h_kv, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    out, lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=causal)
    got = K.flashmask_attention_bwd(q, k, v, out, lse, do, *bounds,
                                    causal=causal)
    pd = _p_dtype(dtype)
    want = K.flashmask_attention_bwd_plain(q, k, v, out, lse, do, *bounds,
                                           causal=causal, p_dtype=pd)
    torch.cuda.synchronize()
    res = _grad_rule(got, want, None if pd is None else _rounding_terms(
        K, q, k, v, out, lse, do, causal, bounds))
    # the library (SDPA with the dense mask) gives NaN on rows that see no
    # key: its accuracy is taken only where every row sees one
    acc = None if pd is None else _accuracy_bwd(
        K, q, k, v, do, got, causal, bounds, dense,
        library=bool(dense.any(-1).all()))
    elt = q.element_size()
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense, enable_gqa=h != h_kv)
        dot = do.transpose(1, 2)
        lib = _time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        del o
    del dense
    res.update({
        "got": got, "want": want, "pairs": pairs, "acc": acc,
        "flops": 10 * d * pairs,     # S, dP, dV, dQ, dK over visible pairs
        "bytes": (4 * q.numel() + 4 * k.numel()) * elt + lse.numel() * 4 +
        _bounds_bytes(bounds),
        "ms": _time_ms(lambda: K.flashmask_attention_bwd(
            q, k, v, out, lse, do, *bounds, causal=causal)),
        "plain_ms": _time_ms(lambda: K.flashmask_attention_bwd_plain(
            q, k, v, out, lse, do, *bounds, causal=causal, p_dtype=pd),
            ITERS // 10),
        "library_ms": lib})
    return res


def check_bdrln(K, dev, dtype, rng, rows, h, p, eps=1e-12):
    """bias + dropout + residual + LayerNorm against its plain version: y
    within one bf16 rounding (float32: 1e-4; it is expected bit-equal),
    the keep mask equal bit for bit, the keep rate within 5 sigma of
    1 - p, and out (bf16) within one bf16 ulp plus 2^-16 of its terms,
    |n w| + |b| (n the normalized value): out = n w + b cancels where
    n w ~ -b, and there the float32 means and variances of the two sides,
    summed in other orders, differ by ~1e-7 of the terms, more than a bf16
    ulp of a small result. No single PyTorch call computes this; the
    composition F.layer_norm(residual + F.dropout(x + bias)) is timed
    beside it (printed, not a library time)."""
    f = torch.nn.functional
    x, r = (torch.from_numpy(rng.standard_normal(
        (rows, h), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    w, bb, bias = (torch.from_numpy(rng.standard_normal(
        (h,), dtype=np.float32)).to(dev, dtype) for _ in range(3))
    seed = int(rng.integers(0, 2 ** 31 - 1))
    out, y, keep = K.bias_dropout_residual_ln(x, r, w, bb, bias, eps, p,
                                              seed)
    w_out, w_y, w_keep = K.bias_dropout_residual_ln_plain(x, r, w, bb, bias,
                                                          eps, p, seed)
    torch.cuda.synchronize()
    if p > 0.0:
        if not torch.equal(keep, w_keep):
            raise AssertionError("bdrln: the kernel's keep mask differs from "
                                 "the plain Philox mask")
        rate = float(keep.float().mean())
        sigma = (p * (1 - p) / keep.numel()) ** 0.5
        if abs(rate - (1 - p)) > 5 * sigma:
            raise AssertionError(f"bdrln: keep rate {rate} not within 5 "
                                 f"sigma of {1 - p}")
    elif keep is not None or w_keep is not None:
        raise AssertionError("bdrln: p = 0 wrote a keep mask")
    y_ok = bool(((y.float() - w_y.float()).abs() <=
                 (_ulp_bf16(w_y.float()) if dtype != torch.float32 else
                  1e-4)).all())
    if not y_ok:
        raise AssertionError("bdrln: y differs from the plain version by "
                             "more than one rounding")
    want = w_out.float()
    allow = _ulp_bf16(want) + 2.0 ** -16 * ((want - bb.float()).abs() +
                                           bb.float().abs())
    worst = float(((out.float() - want).abs() / allow).max())
    comp = _time_ms(lambda: f.layer_norm(
        r + f.dropout(x + bias, p), (h,), w, bb, eps))
    elt = x.element_size()
    n = x.numel()
    return {"got": out, "want": w_out, "err": _max_err(out, w_out),
            "y_err": _max_err(y, w_y), "worst": worst,
            "keep_rate": float(keep.float().mean()) if keep is not None
            else 1.0,
            "composition_ms": comp,
            "flops": 10 * n,
            # x, residual read; out, y written; the mask byte when p > 0;
            # bias, w, b read once
            "bytes": 4 * n * elt + (n if p > 0.0 else 0) + 3 * h * elt,
            "ms": _time_ms(lambda: K.bias_dropout_residual_ln(
                x, r, w, bb, bias, eps, p, seed)),
            "plain_ms": _time_ms(lambda: K.bias_dropout_residual_ln_plain(
                x, r, w, bb, bias, eps, p, seed)),
            "library_ms": None}


def _rope_path(run, counter):
    """The path ("vector" or "scalar") that `run`, one RoPE launch
    counted on `counter` (K.fused_rope or K.fused_rope_bwd), takes."""
    before = counter.scalar_launches
    run()
    return "scalar" if counter.scalar_launches > before else "vector"


def check_rope(K, dev, dtype, rng, b=4, s=256, h=32, d=128):
    """RoPE of one tensor with float32 [S, D] tables; by default on the
    dense admission's q, [4, 256, 32, 128]. The parent: its kernel."""
    x = torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype)
    cos = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    sin = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    got = K.fused_rope(x, cos, sin)
    want = K.fused_rope_plain(x, cos, sin)
    torch.cuda.synchronize()

    def run():
        return K.fused_rope(x, cos, sin)

    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 3 * x.numel(),
            "bytes": 2 * x.numel() * x.element_size() + 2 * cos.numel() * 4,
            **_with_parent(run, lambda: _parent_rope(x, cos, sin), "rope",
                           want),
            "plain_ms": _time_ms(lambda: K.fused_rope_plain(x, cos, sin)),
            "library_ms": None, "route": _rope_path(run, K.fused_rope)}


def check_rope_qk(K, dev, dtype, rng, b, s, hq, hk, d=128, rows=False,
                  bwd=False, table_dtype=torch.float32):
    """q [b, s, hq, d] and k [b, s, hk, d] in one launch of the RoPE
    kernel: forward with [S, D] tables, or (rows) with per-token rows
    ([b, d] when s = 1, the decode step's; else [b, s, d], the ragged
    chunk's), or (bwd) the transposed form on two gradients. Held against
    the plain versions on q and on k. The parent: its kernel on q and on k
    (two launches); for the rows forms the parent tree's plain _rope_rows
    on q and on k, and for the backward its plain backward on each (the
    parent had no kernel for these)."""
    q = torch.from_numpy(rng.standard_normal(
        (b, s, hq, d), dtype=np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal(
        (b, s, hk, d), dtype=np.float32)).to(dev, dtype)
    shape = ((b, d) if s == 1 else (b, s, d)) if rows else (s, d)
    cos, sin = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, table_dtype) for _ in range(2))
    if bwd:
        def run():
            return K.fused_rope_bwd(q, cos, sin, k)

        def plain():
            return (K.fused_rope_bwd_plain(q, cos, sin),
                    K.fused_rope_bwd_plain(k, cos, sin))
        parent, counter = plain, K.fused_rope_bwd
    else:
        one = K.fused_rope_rows_plain if rows else K.fused_rope_plain

        def run():
            return K.fused_rope_qk(q, k, cos, sin)

        def plain():
            return one(q, cos, sin), one(k, cos, sin)

        def parent():
            return _parent_rope(q, cos, sin), _parent_rope(k, cos, sin)
        if rows:
            parent = plain
        counter = K.fused_rope
    got, want = _flat(run()), _flat(plain())
    torch.cuda.synchronize()
    n = q.numel() + k.numel()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 3 * n,
            "bytes": 2 * n * q.element_size() +
            2 * cos.numel() * cos.element_size(),
            **_with_parent(run, parent, "rope", want),
            "plain_ms": _time_ms(plain), "library_ms": None,
            "route": _rope_path(run, counter)}


def _over_allowed(n):
    """Elements of a 16-bit flash gradient of n elements that may pass the
    per-element allowance (see _within)."""
    return max(math.ceil(BWD_OVER_SHARE * n), BWD_OVER_FLOOR)


def _within(name, res, dtype):
    """Tolerances: float32 1e-4 absolute for every kernel (the kernels and
    the plain versions sum in other orders); bfloat16 2e-2 absolute for
    attention (outputs of magnitude < 1, one bf16 rounding of each side)
    and one bf16 ulp of the plain result for the elementwise kernels
    (both round one float32 value that differs in its last bits; RoPE
    rounds in the same order on both sides and is expected exact). The
    flash backward's dq, dk and dv sum thousands of terms in float32 on
    both sides and round once. Their values fall off along the causal rows,
    so a typical |dq|, |dk|, |dv| (mean and rms, printed) lies far below
    the largest: in float32 each is held to 1e-4 of its own largest value
    (errors ~1e-6 of it); in bfloat16 each ELEMENT is held to 2^-7 of its
    own size (one bf16 rounding, up to 2^-7 relative, of two float32 values
    that differ in their last bits) plus a floor of 2^-8 of the tensor's
    rms (elements near zero, where the float32 sums cancel), so an error
    the size of a typical value anywhere fails.

    The 16-bit flash kernels (bfloat16, float16: the tensor-core route)
    round P and dS to the input type before the dV, dK and dQ products, as
    the TPU kernel does, and are held against the plain version that rounds
    at the same points (forward: 2e-2 absolute, as above). Both sides round
    float32 values that differ in their last bits, so where a value sits at
    a rounding midpoint the two take neighbouring 16-bit values: one term
    of the sum moves by one ulp, up to 2^-7 of itself. Such a flip can
    carry an element past the rule above where a few large terms cancel:
    flash_rounding_check.py shows the plain version itself, against a
    float64 version with the same roundings, past it on about one element
    in a million at [4, 2048, 16, 128], by up to 2x, while the kernels'
    float32 accumulation is exact to half an ulp. So in 16 bits at most
    max(ceil(BWD_OVER_SHARE n), BWD_OVER_FLOOR) of the n elements of each
    of dq, dk and dv may pass that allowance, and none may pass it plus
    2^-7 times the sum of its product's absolute terms over the rounded
    operand (scale |dS||K|, scale |dS|^T|Q|, P^T|dO|: every term flipped at
    once). The floor of a few elements is for small shapes, where a share
    of 1e-5 is one or two elements: at [2, 300, 8 -> 4, 64] the plain
    version against a float64 version with the same roundings passes the
    allowance on up to 3 elements of dq (flash_rounding_check.py --small).
    A kernel wrong by a typical value on a tenth of the keys, or by one
    rms on a tenth of dq's queries, still fails (checked on every run).
    Beside that, each 16-bit row holds the kernel's largest error against
    the float32 plain version (on float32 copies of the inputs) to at most
    LIB_ERR_FACTOR times the library call's (SDPA,
    or its backward) against the same: the redesign is to be as accurate
    as the library, which rounds P and dS to 16 bits too.

    The 16-bit ragged rows (the tensor-core route) are held element by
    element to 2^-7 |want| + 2^-8 rms(want's row over D) against the
    kernel's own walk (the same key tiles, P rounded at the same points),
    so that at 4096 keys, where a typical output is ~0.02, a dropped key
    tile still fails (checked on every run); against the float32-P plain
    version, to that plus half a 16-bit ulp of every rounded P term
    (check_ragged)."""
    if "tiled" in res:
        return res["tiled"] <= 1.0, ("<= 2^-7|want| + 2^-8 rms(row) of the "
                                     f"kernel's walk: worst "
                                     f"{res['tiled']:.3f}")
    if name in ("flash_attention_bwd", "flashmask_attention_bwd"):
        if dtype == torch.float32:
            ok = all(e <= 1e-4 * max(1.0, m)
                     for e, m in zip(res["errs"], res["scales"]))
            return ok, "<= 1e-4 of max|grad| per dq/dk/dv"
        ok = all(c <= _over_allowed(n)
                 for c, n in zip(res["over_n"], res["n"])) and \
            all(w <= 1.0 for w in res["bound"])
        return ok, (f"<= 2^-7|want| + 2^-8 rms(want) but for <= "
                    f"max(ceil({BWD_OVER_SHARE:g} n), {BWD_OVER_FLOOR}) "
                    f"elements; all <= that + 2^-7 sum|terms|")
    if dtype == torch.float32:
        return res["err"] <= TOL[dtype], f"<= {TOL[dtype]}"
    if name == "bias_dropout_residual_ln":
        return res["worst"] <= 1.0, ("<= 1 bf16 ulp + 2^-16 (|n w| + |b|); "
                                     f"worst ratio {res['worst']:.3f}")
    if name in ("rms_norm", "swiglu", "fused_rope", "fused_rope_bwd"):
        want = res["want"].float()
        ok = bool(((res["got"].float() - want).abs()
                   <= _ulp_bf16(want)).all())
        return ok, "<= 1 bf16 ulp"
    return res["err"] <= TOL[dtype], f"<= {TOL[dtype]}"


def phase_kernels(K, dev):
    """Every kernel against its plain version at the serving shapes, in
    bf16 and f32. Returns {name: bf16 record} for the JSON line."""
    rng = np.random.default_rng(0)
    rng8 = np.random.default_rng(1)      # the int8 cases' own inputs
    # the ragged rows added with the tensor-core ragged kernel, drawing
    # apart so that every earlier row keeps its inputs
    rng_r = np.random.default_rng(3)
    # the RoPE kernel's forms added with its redesign, likewise apart
    rng_p = np.random.default_rng(4)
    # the speculative verify windows, likewise apart
    rng_v = np.random.default_rng(5)
    # GPT-3 1.3B's and BERT-base's shapes, likewise apart
    rng_g = np.random.default_rng(6)
    out = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        if dtype == torch.float16:
            # the tensor-core kernels' float16 instantiations
            cases = [
                ("flash_attention[f16]", lambda: check_flash(
                    K, dev, dtype, rng, 2, 512, 512, 16, 16)),
                ("flash_attention_bwd[f16]", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 2, 512, 512, 16, 16)),
                ("ragged_paged_attention[f16]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r)),
                ("fused_rope[qk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8)),
            ]
            _run_cases(cases, dtype, out)
            continue
        cases = [
            ("ragged_paged_attention", lambda: check_ragged(
                K, dev, dtype, 32, rng)),
            ("ragged_paged_attention[gqa8]", lambda: check_ragged(
                K, dev, dtype, 8, rng)),
            ("paged_decode_attention", lambda: check_decode(
                K, dev, dtype, rng)),
            ("paged_decode_attention[gqa8]", lambda: check_decode(
                K, dev, dtype, rng, h_kv=8)),
            ("rms_norm", lambda: check_rms(K, dev, dtype, rng)),
            ("swiglu", lambda: check_swiglu(K, dev, dtype, rng)),
            # the dense admission of the serve:dense run: c = 4 rows of 256
            ("flash_attention", lambda: check_flash(
                K, dev, dtype, rng, 4, 256, 256, 32, 32)),
            ("flash_attention[gqa8]", lambda: check_flash(
                K, dev, dtype, rng, 4, 256, 256, 32, 8)),
            ("flash_attention[s2048]", lambda: check_flash(
                K, dev, dtype, rng, 1, 2048, 2048, 32, 32)),
            ("fused_rope", lambda: check_rope(K, dev, dtype, rng)),
            # int8 pages: no single PyTorch call attends over paged int8
            # KV, so there is no library time
            ("ragged_paged_attention_int8", lambda: check_ragged(
                K, dev, dtype, 32, rng8, int8=True)),
            ("ragged_paged_attention_int8[gqa8]", lambda: check_ragged(
                K, dev, dtype, 8, rng8, int8=True)),
            ("paged_decode_attention_int8", lambda: check_decode(
                K, dev, dtype, rng8, int8=True)),
            ("paged_decode_attention_int8[gqa8]", lambda: check_decode(
                K, dev, dtype, rng8, h_kv=8, int8=True)),
            # contexts up to the engine's whole table (4096 tokens)
            ("paged_decode_attention[long]", lambda: check_decode(
                K, dev, dtype, rng, lens=LONG_LENS)),
            ("paged_decode_attention_int8[long]", lambda: check_decode(
                K, dev, dtype, rng8, int8=True, lens=LONG_LENS)),
            # the decode step's RMSNorm (65 launches a step at B = 4) and
            # a width that is no whole number of vectors (the scalar path)
            ("rms_norm[decode]", lambda: check_rms(K, dev, dtype, rng, 4,
                                                   4096)),
            ("rms_norm[odd]", lambda: check_rms(K, dev, dtype, rng, 37,
                                                333)),
            # 16 query heads a KV head: two row groups of 8 per page range
            ("paged_decode_attention[rep16]", lambda: check_decode(
                K, dev, dtype, rng, h_kv=2, lens=(300, 17), b=2,
                d=64, p_max=32)),
        ]
        if dtype == torch.bfloat16:
            # the tensor-core ragged kernel's edges: contexts up to the
            # engine's whole table, D = 64 (GQA 8 -> 4), a short window
            cases += [
                ("ragged_paged_attention[long]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, rows=RAGGED_LONG)),
                ("ragged_paged_attention_int8[long]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, int8=True, rows=RAGGED_LONG)),
                ("ragged_paged_attention[d64]", lambda: check_ragged(
                    K, dev, dtype, 4, rng_r, h=8, d=64)),
                ("ragged_paged_attention[q8]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, rows=RAGGED_Q8, q_max=8)),
                ("ragged_paged_attention_int8[q8]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, int8=True, rows=RAGGED_Q8,
                    q_max=8)),
                ("ragged_paged_attention[verify]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_v, rows=RAGGED_VERIFY, q_max=8)),
                ("ragged_paged_attention_int8[verify]",
                 lambda: check_ragged(K, dev, dtype, 32, rng_v, int8=True,
                                      rows=RAGGED_VERIFY, q_max=8)),
                ("ragged_paged_attention[c40]", lambda: check_ragged(
                    K, dev, dtype, 8, rng_r, rows=RAGGED_C40, p_max=64)),
            ]
            # GPT-3 1.3B serving (16 heads = 16 KV heads of 128, the
            # engine's table of 128 pages of 16; its dense admission
            # [4, 256]) and BERT-base's encoder (non-causal, D = 64, batch
            # 8 x 512)
            cases += [
                ("paged_decode_attention[gpt]", lambda: check_decode(
                    K, dev, dtype, rng_g, h_kv=16, h=16, p_max=128)),
                ("paged_decode_attention_int8[gpt]", lambda: check_decode(
                    K, dev, dtype, rng_g, h_kv=16, int8=True, h=16,
                    p_max=128)),
                ("ragged_paged_attention[gpt]", lambda: check_ragged(
                    K, dev, dtype, 16, rng_g, h=16, p_max=128)),
                ("ragged_paged_attention_int8[gpt]", lambda: check_ragged(
                    K, dev, dtype, 16, rng_g, int8=True, h=16, p_max=128)),
                ("flash_attention[gpt,admit]", lambda: check_flash(
                    K, dev, dtype, rng_g, 4, 256, 256, 16, 16)),
                ("flash_attention[bert]", lambda: check_flash(
                    K, dev, dtype, rng_g, 8, 512, 512, 12, 12, d=64,
                    causal=False)),
            ]
            # the training step's shapes: [train] runs B=4, S=2048, 16
            # heads of 128; GQA at the 7B width
            cases += [
                ("rms_norm[train]", lambda: check_rms(
                    K, dev, dtype, rng, 8192, 2048)),
                ("swiglu[train]", lambda: check_swiglu(
                    K, dev, dtype, rng, 8192, 5504)),
                ("fused_rope[train]", lambda: check_rope(
                    K, dev, dtype, rng, 4, 2048, 16, 128)),
                # the RoPE kernel's forms on the main path: q and k of the
                # dense admission (7B heads; GQA 8), the paged steps'
                # per-token rows (a decode step at 4 slots, a ragged chunk
                # of 4 x 256), the training step's q and k and their
                # gradients; then tables in x's type (a model cast with
                # .to(dtype)) and a head dim of 18 (the scalar path)
                ("fused_rope[qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32)),
                ("fused_rope[qk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8)),
                ("fused_rope[rows,decode]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 1, 32, 32, rows=True)),
                ("fused_rope[rows,chunk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32, rows=True)),
                ("fused_rope[train,qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 2048, 16, 16)),
                ("fused_rope_bwd[train]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 2048, 16, 16, bwd=True)),
                ("fused_rope[qk,x_tables]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8,
                    table_dtype=dtype)),
                ("fused_rope[rows,d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18, rows=True)),
                ("fused_rope_bwd[d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18, bwd=True)),
                ("flash_attention[train]", lambda: check_flash(
                    K, dev, dtype, rng, 4, 2048, 2048, 16, 16)),
                ("flash_attention_bwd", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 4, 2048, 2048, 16, 16)),
                ("flash_attention_bwd[gqa8]", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 1, 2048, 2048, 32, 8)),
                # flashmask: a packed-document causal mask at the training
                # shape, per-KV-head 2-bound causal under GQA at the 7B
                # width, bidirectional 4 bounds, a causal window of 256
                ("flashmask_attention", lambda: check_flashmask(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "doc")),
                ("flashmask_attention_bwd", lambda: check_flashmask_bwd(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "doc")),
                ("flashmask_attention[gqa8]", lambda: check_flashmask(
                    K, dev, dtype, rng, 1, 2048, 32, 8, "gqa")),
                ("flashmask_attention_bwd[gqa8]", lambda: check_flashmask_bwd(
                    K, dev, dtype, rng, 1, 2048, 32, 8, "gqa")),
                ("flashmask_attention[bidir4]", lambda: check_flashmask(
                    K, dev, dtype, rng, 2, 1024, 16, 16, "bidir")),
                ("flashmask_attention_bwd[bidir4]",
                 lambda: check_flashmask_bwd(
                     K, dev, dtype, rng, 2, 1024, 16, 16, "bidir")),
                ("flashmask_attention[window256]", lambda: check_flashmask(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "window")),
                ("flashmask_attention_bwd[window256]",
                 lambda: check_flashmask_bwd(
                     K, dev, dtype, rng, 4, 2048, 16, 16, "window")),
                # BERT-base's FFN epilogue: 32 x 512 tokens of 768
                ("bias_dropout_residual_ln", lambda: check_bdrln(
                    K, dev, dtype, rng, 16384, 768, 0.1)),
                ("bias_dropout_residual_ln[p0]", lambda: check_bdrln(
                    K, dev, dtype, rng, 16384, 768, 0.0)),
            ]
        # the edges of both flash routes (bf16: tensor cores; f32: SIMT):
        # bottom-right causal alignment (S_q < S_k); rows that see no key
        # (S_q > S_k); ragged tiles (S = 300, no multiple of 64 or 128);
        # D = 64; GQA; the masked forms at a small shape
        cases += [
            ("flash_attention[bottom_right]", lambda: check_flash(
                K, dev, dtype, rng, 1, 100, 300, 32, 32)),
            ("flash_attention[q_longer]", lambda: check_flash(
                K, dev, dtype, rng, 1, 300, 100, 32, 32)),
            ("flash_attention[s300]", lambda: check_flash(
                K, dev, dtype, rng, 2, 300, 300, 8, 4)),
            ("flash_attention[d64]", lambda: check_flash(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, d=64)),
            ("flash_attention_bwd[bottom_right]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 1, 100, 300, 8, 8, library=False)),
            ("flash_attention_bwd[q_longer]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 1, 300, 100, 8, 8, library=False)),
            ("flash_attention_bwd[s300]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, library=False)),
            ("flash_attention_bwd[small]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, d=64,
                library=False)),
            ("flashmask_attention[small]", lambda: check_flashmask(
                K, dev, dtype, rng, 2, 300, 8, 4, "bidir", d=64,
                library=False)),
            ("flashmask_attention_bwd[small]",
             lambda: check_flashmask_bwd(
                 K, dev, dtype, rng, 2, 300, 8, 4, "gqa", d=64,
                 library=False)),
        ]
        if dtype == torch.float32:
            cases += [
                # the RoPE kernel in float32: the dense admission's q and
                # k, a ragged chunk's rows under GQA 8, the gradients, the
                # tiny model's D = 16 and the scalar path's D = 18
                ("fused_rope[qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32)),
                ("fused_rope[rows,chunk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8, rows=True)),
                ("fused_rope_bwd[gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8, bwd=True)),
                ("fused_rope[rows,d16]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 4, 2, d=16, rows=True)),
                ("fused_rope[qk,d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18)),
                # the tiny model's heads (D = 16, rep 2) over a table of 64
                # pages of 4: the vector path with four floats a lane, two
                # page ranges and the merge, an idle slot; D = 18: the
                # scalar path
                ("paged_decode_attention[d16]", lambda: check_decode(
                    K, dev, dtype, rng, h_kv=2, lens=(200, 97, 4, 0), h=4,
                    d=16, page=4, p_max=64)),
                ("paged_decode_attention_int8[d16]", lambda: check_decode(
                    K, dev, dtype, rng8, h_kv=2, int8=True,
                    lens=(200, 97, 4, 0), h=4, d=16, page=4, p_max=64)),
                ("paged_decode_attention[d18]", lambda: check_decode(
                    K, dev, dtype, rng, h_kv=4, lens=(600, 129, 1), b=3,
                    h=8, d=18, p_max=40)),
                # an odd h: the scalar path; h > 1536: y recomputed, not
                # cached in shared memory
                ("bias_dropout_residual_ln[odd]", lambda: check_bdrln(
                    K, dev, dtype, rng, 37, 333, 0.2)),
                ("bias_dropout_residual_ln[wide]", lambda: check_bdrln(
                    K, dev, dtype, rng, 64, 4096, 0.1)),
            ]
        _run_cases(cases, dtype, out)
    measure_write_rows(dev)
    return out


# the [kernels] row whose numbers stand for a kernel in the JSON line,
# where it is not the row of the kernel's own name: the RoPE kernel's
# forms as the main path launches them
RECORD_ROWS = {"fused_rope": "fused_rope[qk]",
               "fused_rope_bwd": "fused_rope_bwd[train]"}


def _run_cases(cases, dtype, out):
    """Run [kernels] cases of one type: print each row, raise on a rule
    broken, and keep the bf16 rows of the base names (or RECORD_ROWS) in
    `out` under the base names."""
    for name, run in cases:
        res = run()
        base = name.split("[")[0]
        ok, tol = _within(base, res, dtype)
        bound, by = _bound_ms(res["bytes"], res["flops"], dtype)
        lib = res["library_ms"]
        lse = f" lse_err={res['lse_err']:.3e}" if "lse_err" in res else ""
        if "pairs" in res:
            lse += f" visible_pairs={res['pairs']}"
        if "y_err" in res:
            lse += (f" y_err={res['y_err']:.3e} keep_rate="
                    f"{res['keep_rate']:.6f} keep_mask=bit-equal "
                    f"composition_ms(F.layer_norm(r+F.dropout(x+b)))="
                    f"{res['composition_ms']:.4f}")
        if "plan" in res:
            lse += (f" splits={res['plan'][0]} pages_per_split="
                    f"{res['plan'][1]} launches_per_call="
                    f"{res['launches_per_call']}")
        if "route" in res:
            lse += f" route={res['route']}"
        if "f32p" in res:
            lse += (f" vs_f32P_plain: kernel_err={res['err_f32p']:.3e} "
                    f"err/allowed={res['f32p']:.3f} (<= 1: the same rule "
                    f"+ half an ulp of each P term) dropped_tile: "
                    f"err/allowed={res['dropped']:.1f} (must fail) rows "
                    f"err/rms=" + "/".join(f"{e:.2e}:{r:.2e}"
                                           for e, r in res["rows"]))
        if "parent_ms" in res:
            if "parent_route" in res:
                lse += f" parent_route={res['parent_route']}"
            lse += (f" parent_ms={res['parent_ms']:.4f} (order parent, "
                    f"kernel, kernel, parent: " + "/".join(
                        f"{t:.4f}" for t in res["parent_abba"]) +
                    f"; parent_err={res['parent_err']:.3e})")
        if "errs" in res:
            lse += " dq/dk/dv_err=" + "/".join(
                f"{e:.3e}" for e in res["errs"]) + " max|grad|=" + \
                "/".join(f"{m:.3f}" for m in res["scales"]) + \
                " mean|grad|=" + "/".join(
                    f"{m:.4f}" for m in res["means"]) + " rms=" + \
                "/".join(f"{m:.4f}" for m in res["rms"]) + \
                " err/allowed(bf16 rule)=" + "/".join(
                    f"{w:.3f}" for w in res["worst"])
            if res["over"]:
                lse += " beyond(allowed)=" + "/".join(
                    f"{c}({_over_allowed(n)})" for c, n in
                    zip(res["over_n"], res["n"])) + \
                    " share_beyond=" + "/".join(
                    f"{o:.2e}" for o in res["over"]) + \
                    " err/(allowed+2^-7 sum|terms|)=" + "/".join(
                        f"{w:.3f}" for w in res["bound"])
        acc_ok = True
        if res.get("acc") is not None:
            kerr, lerr = res["acc"]
            fmt = (lambda e: "/".join(f"{x:.3e}" for x in e)) if \
                isinstance(kerr, list) else (lambda e: f"{e:.3e}")
            lse += (f" vs_f32_plain: kernel_err={fmt(kerr)} library_err="
                    f"{'null' if lerr is None else fmt(lerr)}")
            if lerr is not None:
                pairs = zip(kerr, lerr) if isinstance(kerr, list) else \
                    [(kerr, lerr)]
                acc_ok = all(a <= LIB_ERR_FACTOR * b for a, b in pairs)
                lse += f" (kernel <= {LIB_ERR_FACTOR:g}x library)"
        print(f"[kernels] {name:35s} {str(dtype)[6:]:9s} "
              f"max_abs_err={res['err']:.3e} ({tol}){lse} "
              f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={bound:.4f} ({by})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {dtype}: max_abs_err "
                                 f"{res['err']} not {tol}")
        if res.get("f32p", 0.0) > 1.0:
            raise AssertionError(f"{name} {dtype}: the kernel's error "
                                 f"against the float32-P plain version is "
                                 f"{res['f32p']} of its allowance")
        if not acc_ok:
            raise AssertionError(f"{name} {dtype}: the kernel's error "
                                 f"against the float32 plain version is "
                                 f"more than {LIB_ERR_FACTOR:g}x the "
                                 f"library's: {res['acc']}")
        if dtype == torch.bfloat16 and RECORD_ROWS.get(base, base) == name:
            out[base] = {"max_abs_err": res["err"], "ms": res["ms"],
                         "plain_ms": res["plain_ms"], "bound_ms": bound,
                         "bound_by": by, "library_ms": lib}
        del res
    torch.cuda.empty_cache()


def measure_write_rows(dev):
    """The plain int8 page write (page_quant.write_rows, eager PyTorch, no
    kernel of its own) at the decode shape: 4 rows, one per slot, into
    one Llama-2-7B layer pool (1025 pages of 16 x 32 x 128), two of them
    opening a page. Prints the CUDA kernels one call launches (profiler)
    and the host time per call; a decode step makes 64 calls (32 layers,
    K and V)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.quantization import page_quant
    pages = torch.zeros((1025, 16, 32, 128), dtype=torch.int8, device=dev)
    scales = torch.ones(1025, device=dev)
    pids = torch.tensor([5, 9, 13, 0], device=dev)
    offs = torch.tensor([3, 0, 7, 0], device=dev)
    rows = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 32, 128), dtype=np.float32)).to(dev, torch.bfloat16)

    def write():
        page_quant.write_rows(pages, scales, pids, offs, rows)

    write()
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            write()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")) / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        write()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 100
    print(f"[write_rows] decode shape (4 rows, one layer's K): "
          f"kernels_per_call={n:g} host_ms_per_call={host_ms:.4f}; per "
          f"decode step (64 calls): {64 * n:g} launches, "
          f"{64 * host_ms:.2f} ms of host time", flush=True)


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------

SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")


def check_sass(build):
    """The tensor-core kernels as built: every bfloat16 D = 128 kernel of
    the two flash sm90 libraries, and every kernel of the ragged one (both
    16-bit types, D 64 and 128, float and int8 pages),
    must contain tensor-core products (HGMMA, from wgmma) and TMA loads
    (UTMALDG); prints the counts."""
    from pathlib import Path

    tool = Path(build._nvcc()).with_name("cuobjdump")
    for src in SM90_SOURCES + ("ragged_sm90",):
        sass = subprocess.run([str(tool), "-sass", str(build._target(src)[1])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            fn, body = part.split("\n", 1)
            hg, tma = body.count("HGMMA"), body.count("UTMALDG")
            if src == "ragged_sm90":
                # ..._kernelI<T><KV>Li<D>E...
                args = fn.split("ragged_sm90_kernelI")[1]
                t = "f16" if args.startswith("6__half") else "bf16"
                kv = "int8" if args[len("6__half" if t == "f16" else
                                        "13__nv_bfloat16"):][:1] == "a" \
                    else t
                d = args.split("Li")[1].split("E")[0]
                kind = f"ragged<{t},{kv},{d}>"
            else:
                if "__nv_bfloat16Li128E" not in fn:
                    continue
                kind = "dq" if "flash_dq" in fn else (
                    "dkv" if "flash_dkv" in fn else "fwd")
                nm = fn.split("Li128ELi")[1][0]
                kind = f"{kind}<bf16,128,{nm}>"
            print(f"[sass] {src} {kind}: HGMMA {hg} UTMALDG {tma}",
                  flush=True)
            if not hg or not tma:
                raise AssertionError(f"[sass] {src} {kind}: no wgmma or no "
                                     "TMA")


def _ptxas_kernels(log):
    """[(kernel, what ptxas reports for it)] from an `-Xptxas -v` log:
    registers, barriers, stack and spills, the kernel's name demangled
    (c++filt, where the toolkit's host has it) without its parameters."""
    import shutil
    entries, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = [line.split("'")[1], []]
            entries.append(cur)
        elif cur is not None and ("Used" in line or "spill" in line):
            cur[1].append(line.split(":", 1)[-1].strip())
    names = [e[0] for e in entries]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    return [(n.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0], "; ".join(e[1])) for n, e in zip(names, entries)]


def _nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a copy of the parent commit's "
                         "paddle_tpu_torch/csrc: its versions of "
                         f"{', '.join(PARENT_SOURCES)} are built and timed "
                         "beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    parent = _start_parent(args.parent) if args.parent else None
    waited = _build.build_all()
    print(f"[build] seconds per source "
          f"{json.dumps({k: round(v, 2) for k, v in waited.items()})}"
          f" total_s={time.perf_counter() - t0:.2f}", flush=True)
    if parent:
        _finish_parent(parent)
        print(f"[build] the parent's {', '.join(PARENT_SOURCES)} from "
              f"{args.parent}: timed beside this tree's kernels "
              f"(parent_ms)", flush=True)
    for name in _build.SOURCES:
        for kernel, used in _ptxas_kernels(_build.ptxas_report(name)):
            print(f"[ptxas] {name}: {kernel}: {used}")
    check_sass(_build)

    records = phase_kernels(K, dev)
    phase_agree(dev)
    phase_agree_int8(dev)
    phase_agree_train(dev)
    phase_agree_masked(dev)
    phase_agree_spec(dev)
    phase_surface(dev)
    phase_agree_graphs(dev)
    phase_agree_gpt(dev)
    phase_agree_bert(dev)
    phase_agree_train2(dev)
    masked = phase_flashmask(K, dev)
    ffn = phase_fused_ffn(K, dev)
    model = _serving_model(dev)
    serve, serve_out, serve_st = phase_serve(K, model)
    dense, dense_out = phase_serve_dense(K, model)
    serve8, serve8_out, serve8_st = phase_serve(K, model, kv_dtype="int8",
                                                twin=serve_out)
    dense8, _ = phase_serve_dense(K, model, kv_dtype="int8", twin=dense_out)
    spec = phase_serve_spec(K, model, serve_out, serve_st)
    spec8 = phase_serve_spec(K, model, serve8_out, serve8_st,
                             kv_dtype="int8")
    phase_spec_rescore(model)
    phase_spec_rescore(model, kv_dtype="int8")
    del model                            # the next runs read their own peak
    _release()
    gpt = _serving_gpt(dev)
    gserve, gserve_out, _ = phase_serve(K, gpt, name="serve:gpt")
    gserve8, _, _ = phase_serve(K, gpt, kv_dtype="int8", twin=gserve_out,
                                name="serve:gpt")
    gdense, _ = phase_serve_dense(K, gpt, name="serve:gpt:dense")
    del gpt
    bert = phase_bert(K, dev)
    train, model, opt, batch, base = phase_train(K, dev)
    phase_profile_train(model, opt, batch)
    del model, opt, batch
    remat = phase_train_remat(K, dev, base)
    gtrain = phase_train_gpt(K, dev)
    btrain = phase_train_bert(K, dev)
    runs = (serve, dense, serve8, dense8, spec, spec8, gserve, gserve8,
            gdense, bert, train, remat, gtrain, btrain, masked, ffn)
    launches = {k: sum(r[k] for r in runs) for k in K.launch_counts()}
    _require_launched("all serving, BERT, training, flashmask and fused_ffn "
                      "runs", launches, K.KERNELS)

    name_power = _nvidia_smi()
    print(name_power)
    kernels = []
    for name, (_fn, source, replaces) in K.KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **records[name]}
        if name in K.ROUTED:
            # source: the tensor-core kernel, which every 16-bit launch
            # above took; float32 launches take the SIMT kernel
            row["float32_source"] = K.SIMT_SOURCES[name]
            row["launches_by_route"] = {
                rt: launches[f"{name}.{rt}"] for rt in K.ROUTES}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _serving_prompts(rng, n, lo, hi, vocab, shared_len, sharers):
    """n prompts with lengths in [lo, hi); the prompts at the `sharers`
    indices are longer than `shared_len` and start with one common
    `shared_len`-token prefix."""
    shared = rng.integers(1, vocab, shared_len)
    out = []
    for i in range(n):
        length = int(rng.integers(shared_len + 1 if i in sharers else lo,
                                  hi))
        toks = rng.integers(1, vocab, length)
        if i in sharers:
            toks[:shared_len] = shared
        out.append(toks.astype(np.int32))
    return out


def _tiny_pair(dev):
    """A 2-layer tiny Llama in float32 with one set of seeded weights on
    the CPU (plain versions) and on the card (kernels)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(
        state, LlamaForCausalLM(cfg, device=dev))
    return cfg, cpu, gpu


def phase_agree(dev):
    """The tiny pair: generate_batch through the prefix cache, chunked
    prefill and mixed steps must give the same greedy tokens."""
    cfg, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(1)
    prompts = _serving_prompts(rng, 6, 9, 20, cfg.vocab_size, 12, (0, 4))
    kw = dict(max_new_tokens=12, max_slots=2, page_size=4, max_seq_len=64,
              prefix_cache=True, prefill_chunk=8, mixed_step=True)
    want = cpu.generate_batch(prompts, **kw)
    got = gpu.generate_batch(prompts, **kw)
    eng = gpu.get_engine(max_slots=2, page_size=4, max_seq_len=64,
                         prefix_cache=True, prefill_chunk=8, mixed_step=True)
    same = all(np.array_equal(a, b) for a, b in zip(want, got))
    print(f"[agree] tiny f32 cpu-plain vs cuda-kernels: "
          f"{sum(np.array_equal(a, b) for a, b in zip(want, got))}/"
          f"{len(prompts)} requests token-identical; prefix_hits="
          f"{eng.stats['prefix_hits']} mixed_decode_tokens="
          f"{eng.stats['mixed_decode_tokens']}", flush=True)
    if not same:
        for a, b in zip(want, got):
            print(f"[agree]   cpu {a[-12:].tolist()}\n"
                  f"[agree]  cuda {b[-12:].tolist()}")
        raise AssertionError("CPU plain path and CUDA kernel path disagree")
    if eng.stats["prefix_hits"] < 1:
        raise AssertionError("agreement run saw no prefix-cache hit")

    # dense admission: cold prompts of 3-8 tokens fit the chunk of 8; the
    # two sharing a 4-token page take a prefix hit, then the ragged suffix
    prompts = _serving_prompts(np.random.default_rng(3), 6, 3, 9,
                               cfg.vocab_size, 4, (0, 4))
    kw = dict(kw, max_slots=3)           # a fresh engine on each model
    want = cpu.generate_batch(prompts, **kw)
    got = gpu.generate_batch(prompts, **kw)
    st = gpu.get_engine(**{k: v for k, v in kw.items()
                           if k != "max_new_tokens"}).stats
    n_same = sum(np.array_equal(a, b) for a, b in zip(want, got))
    print(f"[agree] dense admission: {n_same}/{len(prompts)} requests "
          f"token-identical; prefill_admits={st['prefill_admits']} "
          f"ragged_steps={st['ragged_steps']} "
          f"prefix_hits={st['prefix_hits']}", flush=True)
    if n_same != len(prompts):
        raise AssertionError("dense admission: CPU plain path and CUDA "
                             "kernel path disagree")
    if st["prefill_admits"] < 1 or st["ragged_steps"] < 1:
        raise AssertionError("dense-admission run did not take both the "
                             "dense prefill and the ragged path")

    ids = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 7))
    want = cpu.generate(ids, max_new_tokens=12, use_cache=True).numpy()
    got = gpu.generate(ids, max_new_tokens=12, use_cache=True).cpu().numpy()
    print(f"[agree] generate(use_cache=True): token-identical="
          f"{np.array_equal(want, got)} {got[0, 7:].tolist()}", flush=True)
    if not np.array_equal(want, got):
        raise AssertionError("generate: CPU plain path and CUDA kernel path "
                             "disagree")


def phase_agree_int8(dev):
    """The tiny pair over int8 KV pages, CPU plain versions against CUDA
    kernels: the chunked workload (prefix hit, chunked and
    suffix prefill, mixed steps), the dense-admission workload, and a fork
    mid-decode (CoW copies of int8 pages and their scale rows) must give
    the same greedy tokens; the GPU runs must launch both int8 attention
    kernels and neither float paged kernel."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, cpu, gpu = _tiny_pair(dev)
    base = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                prefill_chunk=8, mixed_step=True, kv_dtype="int8")
    workloads = [
        ("chunked", _serving_prompts(np.random.default_rng(1), 6, 9, 20,
                                     cfg.vocab_size, 12, (0, 4)), base),
        ("dense admission", _serving_prompts(np.random.default_rng(3), 6, 3,
                                             9, cfg.vocab_size, 4, (0, 4)),
         dict(base, max_slots=3)),
    ]
    K.reset_launch_counts()
    for tag, prompts, kw in workloads:
        runs = []
        for model in (cpu, gpu):
            eng = GenerationEngine(model, **kw)
            rids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            with torch.inference_mode():
                out = eng.run()
            runs.append([out[r] for r in rids])
        st = eng.stats
        n_same = sum(np.array_equal(a, b) for a, b in zip(*runs))
        print(f"[agree:int8] {tag}: {n_same}/{len(prompts)} requests "
              f"token-identical; prefill_admits={st['prefill_admits']} "
              f"ragged_steps={st['ragged_steps']} "
              f"prefix_hits={st['prefix_hits']}", flush=True)
        if n_same != len(prompts):
            raise AssertionError(f"int8 {tag}: CPU plain path and CUDA "
                                 "kernel path disagree")

    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    runs = []
    for model in (cpu, gpu):
        eng = GenerationEngine(model, **base)
        rid = eng.add_request(prompt, max_new_tokens=12)
        with torch.inference_mode():
            while len(eng._reqs[rid].out) < 4:     # mid-decode, tail partial
                eng.step()
            child = eng.fork_request(rid)
            out = eng.run()
        runs.append((out[rid], out[child], eng.blocks.cow_copies))
    (p_cpu, c_cpu, _), (p_gpu, c_gpu, cows) = runs
    same = np.array_equal(p_cpu, p_gpu) and np.array_equal(c_cpu, c_gpu)
    print(f"[agree:int8] fork: token-identical={same} cow_copies={cows} "
          f"parent==fork={np.array_equal(p_gpu, c_gpu)}", flush=True)
    if not same or cows < 1:
        raise AssertionError("int8 fork: CPU plain path and CUDA kernel path "
                             "disagree, or no copy-on-write happened")
    launches = K.launch_counts()
    _require_launched("agree:int8", launches, ("ragged_paged_attention_int8",
                                               "paged_decode_attention_int8"))
    _require_idle("agree:int8", launches, FLOAT_PAGED_KERNELS)


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rms_norm",
                 "swiglu", "fused_rope", "fused_rope_bwd")


def _train_step(model, lr, multi_precision=False):
    """(compile_train_step over the model's loss with AdamW(lr), the
    optimizer)."""
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(lr, parameters=model.parameters(),
                multi_precision=multi_precision)
    return compile_train_step(model, lambda m, i, l: m(i, labels=l),
                              opt), opt


def _release():
    """Free what earlier phases left on the card, so that the next peak
    reading is the next phase's own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_agree_train(dev):
    """The tiny pair trains: the first backward's gradients and 3 steps of
    compile_train_step with AdamW(1e-3) on a fixed batch, CPU plain
    versions against CUDA kernels, in float32. Tolerances: gradients 1e-4
    absolute plus 1e-4 relative, losses 1e-4 (the same float32 products
    summed in other orders by the kernels, cuBLAS and the CPU's BLAS; AdamW
    steps each near-zero gradient by ~lr * sign, so parameters are not
    held, the losses they give are). Every kernel of the training path
    must launch on the card."""
    from paddle_tpu_torch.ops import kernels as K

    _, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cpu.config.vocab_size, (2, 16))
    lab = rng.integers(0, cpu.config.vocab_size, (2, 16))
    lab[0, :3] = -100
    batch = {"cpu": (torch.from_numpy(ids), torch.from_numpy(lab))}
    batch["gpu"] = tuple(t.to(dev) for t in batch["cpu"])
    K.reset_launch_counts()
    grads = {}
    for tag, model in (("cpu", cpu), ("gpu", gpu)):
        model(batch[tag][0], labels=batch[tag][1]).backward()
        grads[tag] = {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    worst = max(float(((grads["gpu"][n] - g).abs() - 1e-4 * g.abs()).max())
                for n, g in grads["cpu"].items())
    losses = {tag: [float(step(*batch[tag])) for _ in range(3)]
              for tag, (step, _) in (("cpu", _train_step(cpu, 1e-3)),
                                     ("gpu", _train_step(gpu, 1e-3)))}
    launches = K.launch_counts()
    loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[agree:train] tiny f32, 3 AdamW steps: losses cpu "
          f"{losses['cpu']} cuda {losses['gpu']} max_err={loss_err:.3e} "
          f"(<= 1e-4); first-step grads max(|err| - 1e-4 |grad|)="
          f"{worst:.3e} (<= 1e-4); launches "
          f"{json.dumps({k: launches[k] for k in TRAIN_KERNELS})}",
          flush=True)
    if worst > 1e-4 or loss_err > 1e-4:
        raise AssertionError("training: CPU plain path and CUDA kernel path "
                             "disagree")
    if not losses["gpu"][-1] < losses["gpu"][0]:
        raise AssertionError("training: the tiny model's loss did not fall")
    _require_launched("agree:train", launches, TRAIN_KERNELS)


def _agree_grads(cpu_t, gpu_t):
    """max(|err| - 1e-4 |want|) over the named tensors' grads (CPU plain
    against CUDA kernels)."""
    return max(float(((g.grad.detach().cpu() - c.grad).abs() -
                      1e-4 * c.grad.abs()).max())
               for c, g in zip(cpu_t, gpu_t))


def phase_agree_masked(dev):
    """The masked and fused paths, CPU plain versions against CUDA kernels,
    in float32: the tiny Llama with a padded-batch attn_mask (logits, loss,
    first gradients), the tiny fused_feedforward (post-norm, gelu, p = 0)
    and F.flashmask_attention in each bound form (out and grads). All
    within 1e-4 (gradients: |err| <= 1e-4 + 1e-4 |grad|). The flashmask
    kernels and the bdrln kernel must launch."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    _, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(7)
    s = 16
    ids = torch.from_numpy(rng.integers(0, cpu.config.vocab_size, (2, s)))
    lab = torch.from_numpy(rng.integers(0, cpu.config.vocab_size, (2, s)))
    lab[1, 11:] = -100
    pos = torch.arange(s)
    mask = (pos[None, :] <= pos[:, None])[None, None] & \
        (pos[None, None, None, :] < torch.tensor([s, 11])[:, None, None, None])
    with torch.no_grad():
        lc = cpu(ids, attn_mask=mask)
        lg = gpu(ids.to(dev), attn_mask=mask.to(dev)).cpu()
    logit_err = _max_err(lc, lg)
    losses = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        loss = model(ids.to(d), labels=lab.to(d), attn_mask=mask.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
    grad_err = _agree_grads(list(cpu.parameters()),
                            list(gpu.parameters()))
    loss_err = abs(losses[0] - losses[1])
    print(f"[agree:masked] tiny Llama, padded batch (lengths {s}/11) with "
          f"attn_mask: logits max_err={logit_err:.3e} loss cpu/cuda="
          f"{losses[0]:.6f}/{losses[1]:.6f} first grads max(|err| - 1e-4 "
          f"|grad|)={grad_err:.3e}", flush=True)
    if logit_err > 1e-4 or loss_err > 1e-4 or grad_err > 1e-4:
        raise AssertionError("agree:masked: the masked Llama disagrees "
                             "between the CPU and the card")

    h, f = 32, 64
    arrs = [rng.standard_normal(shp).astype(np.float32) * sc
            for shp, sc in (((2, 8, h), 1.0), ((h, f), 0.2), ((f, h), 0.2),
                            ((f,), 1.0), ((h,), 1.0), ((h,), 1.0),
                            ((h,), 1.0))]
    outs, leaves = [], []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in arrs]
        o = IF.fused_feedforward(ts[0], ts[1], ts[2], linear1_bias=ts[3],
                                 linear2_bias=ts[4], ln2_scale=ts[5],
                                 ln2_bias=ts[6], dropout1_rate=0.0,
                                 dropout2_rate=0.0, activation="gelu")
        o.backward(torch.ones_like(o))
        outs.append(o.detach().cpu())
        leaves.append(ts)
    ffn_err = _max_err(*outs)
    ffn_grad = _agree_grads(*leaves)
    print(f"[agree:masked] tiny fused_feedforward (post-norm, gelu, p=0): "
          f"out max_err={ffn_err:.3e} grads max(|err| - 1e-4 |grad|)="
          f"{ffn_grad:.3e}", flush=True)
    if ffn_err > 1e-4 or ffn_grad > 1e-4:
        raise AssertionError("agree:masked: fused_feedforward disagrees "
                             "between the CPU and the card")

    b, sq, hq, hkv, d_ = 2, 64, 4, 2, 16
    col = np.arange(sq)
    for causal, nb, kh in ((True, 1, 1), (True, 2, hkv), (False, 2, hq),
                           (False, 4, hkv)):
        shp = (b, kh, sq)
        lts = np.maximum(rng.integers(1, sq + 1, shp), col + 1)
        if causal:
            idx = lts[..., None] if nb == 1 else np.stack(
                [lts, np.minimum(lts + rng.integers(0, sq, shp), sq)], -1)
        else:
            ute = np.minimum(rng.integers(0, sq, shp), col)
            idx = np.stack([lts, ute], -1) if nb == 2 else np.stack(
                [lts, np.minimum(lts + rng.integers(0, sq // 2, shp), sq),
                 np.maximum(ute - rng.integers(0, sq // 2, shp), 0), ute],
                -1)
        idx = torch.from_numpy(idx.astype(np.int32))
        qkv = [rng.standard_normal(shp_).astype(np.float32)
               for shp_ in ((b, sq, hq, d_), (b, sq, hkv, d_),
                            (b, sq, hkv, d_))]
        res = []
        for d in ("cpu", dev):
            ts = [torch.from_numpy(a).to(d).requires_grad_() for a in qkv]
            o, lse = F.flashmask_attention(*ts, idx.to(d), causal=causal,
                                           return_softmax_lse=True)
            o.backward(torch.ones_like(o))
            res.append((o.detach().cpu(), lse.cpu(), ts))
        seen = res[0][1] > -1e29
        err = max(_max_err(res[0][0], res[1][0]),
                  _max_err(res[0][1][seen], res[1][1][seen]))
        g_err = _agree_grads(res[0][2], res[1][2])
        print(f"[agree:masked] F.flashmask_attention causal={causal} "
              f"bounds={nb} kh={kh}: out/lse max_err={err:.3e} grads "
              f"max(|err| - 1e-4 |grad|)={g_err:.3e}", flush=True)
        if err > 1e-4 or g_err > 1e-4:
            raise AssertionError("agree:masked: flashmask disagrees between "
                                 "the CPU and the card")
    _require_launched("agree:masked", K.launch_counts(), MASKED_KERNELS)


# the tiny speculative workload of tests/test_speculative.py: four prompts,
# one of them a repeating pattern the n-gram drafter can follow
SPEC_PROMPTS = ([1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [5, 6, 7, 8] * 5, [42, 17])
# int8 pages: a verify window that opens a page freezes the page's scale
# over every row of the window in it (a decode step: its one row), so
# spec-on tokens may leave spec-off ones, as the JAX engine's do; the
# share of generated tokens allowed to differ (tests/test_kv_int8.py's)
INT8_SPEC_BUDGET = 0.25


def _serve_tiny(model, prompts, n_new, **kw):
    from paddle_tpu_torch.inference import GenerationEngine
    eng = GenerationEngine(model, **kw)
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new)
            for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return eng, [out[r] for r in rids]


def _no_drafter_error(tag, eng):
    fb = eng.stats["spec_fallbacks"]
    if fb.get("drafter_error"):
        raise AssertionError(f"[{tag}] the drafter raised ({fb}): "
                             f"{eng.spec_last_error!r}")


def phase_agree_spec(dev):
    """The tiny pair with speculative decoding, float and int8 pools: the
    n-gram drafter and self-drafting (DraftModelDrafter over the model
    itself), then a long prompt chunking through the ragged program while
    running slots commit spec bundles. CUDA spec-on tokens must equal the
    CPU plain path's spec-on tokens and, over float pools, the spec-off
    tokens (int8: within INT8_SPEC_BUDGET, as on the CPU); float
    self-drafting must accept every draft."""
    from paddle_tpu_torch.inference import DraftModelDrafter
    from paddle_tpu_torch.ops import kernels as K

    _, cpu, gpu = _tiny_pair(dev)
    kw = dict(max_slots=4, page_size=4, max_seq_len=96, mixed_step=False)
    K.reset_launch_counts()
    for kv in (None, "int8"):
        name = "float" if kv is None else "int8"
        off = [_serve_tiny(m, SPEC_PROMPTS, 24, spec_decode=False,
                           kv_dtype=kv, **kw)[1] for m in (cpu, gpu)]
        if not all(np.array_equal(a, b) for a, b in zip(*off)):
            raise AssertionError(f"[agree:spec] {name} spec-off: CPU plain "
                                 "path and CUDA kernel path disagree")
        for drafter in ("ngram", "self-draft"):
            runs = []
            for m in (cpu, gpu):
                spec = "ngram" if drafter == "ngram" else \
                    DraftModelDrafter(m)
                runs.append(_serve_tiny(m, SPEC_PROMPTS, 24, spec_decode=spec,
                                        kv_dtype=kv, **kw))
            (_, on_cpu), (eng, on_gpu) = runs
            st = eng.stats
            same_cpu = all(np.array_equal(a, b)
                           for a, b in zip(on_gpu, on_cpu))
            diff = sum(int(np.count_nonzero(a != b))
                       for a, b in zip(on_gpu, off[1]))
            print(f"[agree:spec] {name} {drafter}: cuda == cpu spec-on "
                  f"{same_cpu}; generated tokens differing from spec-off "
                  f"{diff}/{24 * len(SPEC_PROMPTS)}; verify dispatches="
                  f"{st['spec_dispatches']} drafted="
                  f"{st['spec_draft_tokens']} accepted="
                  f"{st['spec_accepted_tokens']} rollbacks="
                  f"{st['spec_rollbacks']} fallbacks={st['spec_fallbacks']}",
                  flush=True)
            _no_drafter_error("agree:spec", eng)
            if not same_cpu:
                raise AssertionError(f"[agree:spec] {name} {drafter}: CPU "
                                     "plain path and CUDA kernel path "
                                     "disagree")
            if diff > (0 if kv is None else
                       INT8_SPEC_BUDGET * 24 * len(SPEC_PROMPTS)):
                raise AssertionError(f"[agree:spec] {name} {drafter}: "
                                     f"{diff} tokens differ from spec-off")
            if st["spec_dispatches"] < 1 or st["spec_draft_tokens"] < 1:
                raise AssertionError(f"[agree:spec] {name} {drafter}: no "
                                     "verify dispatch drafted anything")
            if kv is None and drafter == "self-draft" and \
                    st["spec_accepted_tokens"] != st["spec_draft_tokens"]:
                raise AssertionError("[agree:spec] float self-drafting "
                                     "rejected a draft")

    # the chunked-prefill interleave: a 40-token prompt (5 chunks of 8)
    # admitted mid-decode while self-drafted bundles commit
    long_prompt = np.random.RandomState(7).randint(1, 128, size=40)
    ikw = dict(max_slots=3, page_size=4, max_seq_len=96, prefill_chunk=8,
               mixed_step=False)

    def interleave(model, spec):
        from paddle_tpu_torch.inference import GenerationEngine
        eng = GenerationEngine(model, spec_decode=spec, **ikw)
        r1 = eng.add_request(np.tile(np.array([5, 6, 7, 8]), 4), 24)
        r2 = eng.add_request(np.array([9, 8, 7]), 24)
        with torch.inference_mode():
            while not (eng._reqs[r1].out and eng._reqs[r2].out):
                eng.step()
            r3 = eng.add_request(long_prompt, 12)
            out = eng.run()
        return eng, [out[r] for r in (r1, r2, r3)]

    _, want = interleave(cpu, False)
    eng, got = interleave(gpu, DraftModelDrafter(gpu))
    _, off = interleave(gpu, False)
    st = eng.stats
    same = all(np.array_equal(a, b) for a, b in zip(got, want)) and \
        all(np.array_equal(a, b) for a, b in zip(got, off))
    print(f"[agree:spec] chunked-prefill interleave (self-draft): cuda "
          f"spec-on == cuda spec-off == cpu {same}; ragged_steps="
          f"{st['ragged_steps']} verify dispatches={st['spec_dispatches']} "
          f"accepted={st['spec_accepted_tokens']}/"
          f"{st['spec_draft_tokens']}", flush=True)
    _no_drafter_error("agree:spec", eng)
    if not same or st["ragged_steps"] < 5 or \
            st["spec_accepted_tokens"] != st["spec_draft_tokens"]:
        raise AssertionError("[agree:spec] the interleave disagrees, or did "
                             "not chunk, or rejected a self-draft")
    _require_launched("agree:spec", K.launch_counts(), RAGGED_KERNELS)


# the weight [surface] changes in place mid-run (x 3: the tokens move)
SWAP_PARAM = "llama.layers.0.self_attn.o_proj.weight"


def phase_surface(dev):
    """The request lifecycle on the card (tiny f32 pair): two threads
    streaming from one engine, a cancel that frees every page at once, an
    export/import round trip through the CPU engine and back, and a weight
    swap mid-run, each held to the CPU plain path's tokens."""
    import threading

    from paddle_tpu_torch.inference import (GenerationEngine,
                                            RequestCancelledError)

    _, cpu, gpu = _tiny_pair(dev)
    prompts = [np.array(p) for p in SPEC_PROMPTS[:3]]
    kw = dict(max_slots=2, page_size=4, max_seq_len=64, mixed_step=False)
    want = _serve_tiny(cpu, prompts, 16, **kw)[1]
    gen = [w[len(p):].tolist() for w, p in zip(want, prompts)]

    eng = GenerationEngine(gpu, **kw)
    got = {}

    def consume(idx):
        for i in idx:
            got[i] = list(eng.stream(prompts[i], 16))

    threads = [threading.Thread(target=consume, args=(idx,))
               for idx in ([0, 2], [1])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    streams_ok = got == dict(enumerate(gen))

    it = eng.stream(prompts[0], 16)
    next(it)
    rid = max(eng._reqs)
    eng.cancel_request(rid)
    freed = bool(np.all(eng.blocks.refcount[1:] == 0))
    try:
        list(it)
        cut = False
    except RequestCancelledError:
        cut = True

    # export mid-decode -> the CPU engine -> export -> back to the card
    rid = eng.add_request(prompts[2], max_new_tokens=16)
    with torch.inference_mode():
        while len(eng._reqs[rid].out) < 3:
            eng.step()
    snap = eng.remove_request(rid)
    ceng = GenerationEngine(cpu, **kw)
    crid = ceng.import_request(snap)
    with torch.inference_mode():
        while len(ceng._reqs[crid].out) < 4:
            ceng.step()
    snap2 = ceng.remove_request(crid)
    rid = eng.import_request(snap2)
    round_trip = np.array_equal(eng.run()[rid], want[2])

    # a swap mid-run on fresh copies (the same change on both devices)
    _, cpu2, gpu2 = _tiny_pair(dev)
    outs = []
    for m in (cpu2, gpu2):
        e = GenerationEngine(m, **kw)
        rids = [e.add_request(p, max_new_tokens=16) for p in prompts[:2]]
        with torch.inference_mode():
            while not all(len(e._reqs[r].out) >= 2 for r in rids):
                e.step()
        w = dict(m.named_parameters())[SWAP_PARAM]
        e.swap_weights(lambda w=w: w.mul_(3.0), tag="b")
        with torch.inference_mode():
            res = e.run()
        outs.append(([res[r] for r in rids], e._weight_epoch,
                     len(e.blocks._index)))
    swap_ok = all(np.array_equal(a, b) for a, b in zip(outs[0][0],
                                                       outs[1][0]))
    moved = any(not np.array_equal(a, w) for a, w in zip(outs[1][0], want))
    print(f"[surface] two threads streaming == cpu run(): {streams_ok}; "
          f"cancel freed every page: {freed}, stream raised "
          f"RequestCancelledError: {cut}; export/import card -> cpu -> card "
          f"token-exact: {round_trip}; swap_weights mid-run: cuda == cpu {swap_ok}, "
          f"tokens moved {moved}, epoch {outs[1][1]}, index entries after "
          f"{outs[1][2]}", flush=True)
    if not (streams_ok and freed and cut and round_trip and swap_ok and
            moved and outs[1][1] == 1 and outs[1][2] == 0):
        raise AssertionError("[surface] the lifecycle surface disagrees "
                             "with the CPU plain path")


def _set_graphs(eng, on):
    """Graphs on or off (the private eager twin) for an engine and its
    draft model's private engine; before the engine's first step."""
    eng._graphs = on
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        inner._graphs = on


def _trace_counts(eng):
    """The engine's trace counters (the JAX engine's names), and the draft
    model's engine's under "draft."."""
    from paddle_tpu_torch.inference.programs import TRACE_COUNTERS
    out = {n: getattr(eng, n) for n in TRACE_COUNTERS.values()}
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        out.update({f"draft.{n}": getattr(inner, n)
                    for n in TRACE_COUNTERS.values()})
    return out


def _captures(eng):
    """{kind: CUDA graphs captured} of the engine (and its draft
    engine's, under "draft.")."""
    out = {k: v for k, v in eng._programs.captured().items() if v}
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        out.update({f"draft.{k}": v for k, v in
                    inner._programs.captured().items() if v})
    return out


def _wave(eng, prompts, n_new, temperature=0.0):
    """One wave of requests through a (reused) engine; the prefix index is
    dropped first, so a repeat wave sees the shapes of the first."""
    eng.blocks.invalidate_index()
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new,
                            temperature=temperature) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return [out[r] for r in rids]


def phase_agree_graphs(dev):
    """The tiny f32 model on the card, every step program a replayed CUDA
    graph against the eager twin (``_graphs = False``): greedy and seeded
    sampled tokens, float and int8 pools, the prefix-sharing chunked
    workload and the dense-admission one, a fork mid-decode (the CoW copy
    program) and self-drafting spec must be token-identical, with equal
    kernel launch counts (the replays' counted from their captures); a
    second wave of the same shapes adds nothing to any trace counter (the
    draft engine's too); a weight swap through an in-place loader keeps
    every program and gives a fresh engine's tokens, and a loader that
    moves a parameter drops them (the counters show the rebuilds)."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, _, gpu = _tiny_pair(dev)
    chunked = (_serving_prompts(np.random.default_rng(1), 6, 9, 20,
                                cfg.vocab_size, 12, (0, 4)),
               dict(max_slots=2, page_size=4, max_seq_len=64,
                    prefix_cache=True, prefill_chunk=8, mixed_step=True))
    dense = (_serving_prompts(np.random.default_rng(3), 6, 3, 9,
                              cfg.vocab_size, 4, (0, 4)),
             dict(max_slots=3, page_size=4, max_seq_len=64,
                  prefix_cache=True, prefill_chunk=8, mixed_step=True))
    spec_kw = dict(max_slots=4, page_size=4, max_seq_len=96,
                   mixed_step=False)
    bad = []
    for kv in (None, "int8"):
        name = "float" if kv is None else "int8"
        cases = [(f"{name} chunked+prefix {mode}", chunked, t)
                 for mode, t in (("greedy", 0.0), ("sampled", 0.8))]
        cases += [(f"{name} dense admission {mode}", dense, t)
                  for mode, t in (("greedy", 0.0), ("sampled", 0.8))]
        for tag, (prompts, kw), temp in cases:
            runs = []
            for on in (True, False):
                eng = GenerationEngine(gpu, kv_dtype=kv, seed=11, **kw)
                _set_graphs(eng, on)
                K.reset_launch_counts()
                first = _wave(eng, prompts, 12, temp)
                launches = K.launch_counts()
                marks = _trace_counts(eng)
                _wave(eng, prompts, 12, temp)
                runs.append((first, launches, marks, _trace_counts(eng),
                             _captures(eng)))
            (g_tok, g_l, g_m, g_m2, caps), (e_tok, e_l, _, _, _) = runs
            same = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
            frozen = g_m == g_m2
            print(f"[agree:graphs] {tag}: graphs == eager {same}; launches "
                  f"equal {g_l == e_l}; repeat wave adds no program "
                  f"{frozen} {json.dumps(g_m)}; captured {json.dumps(caps)}",
                  flush=True)
            if not (same and g_l == e_l and frozen and caps):
                bad.append(tag)

        # a fork mid-decode: the CoW copy program
        runs = []
        for on in (True, False):
            eng = GenerationEngine(gpu, kv_dtype=kv, **chunked[1])
            _set_graphs(eng, on)
            rid = eng.add_request(np.array([3, 1, 4, 1, 5]), 12)
            with torch.inference_mode():
                while len(eng._reqs[rid].out) < 4:
                    eng.step()
                child = eng.fork_request(rid)
                out = eng.run()
            runs.append(([out[rid], out[child]], eng.copy_trace_count,
                         _captures(eng).get("copy", 0)))
        same = all(np.array_equal(a, b) for a, b in zip(runs[0][0],
                                                         runs[1][0]))
        print(f"[agree:graphs] {name} fork: graphs == eager {same}; copy "
              f"programs {runs[0][1]}, captured {runs[0][2]}", flush=True)
        if not (same and runs[0][2] >= 1):
            bad.append(f"{name} fork")

        # self-drafting: the verify program and the draft engine's
        runs = []
        for on in (True, False):
            eng = GenerationEngine(gpu, kv_dtype=kv,
                                   spec_decode=DraftModelDrafter(
                                       gpu, kv_dtype=kv), **spec_kw)
            _set_graphs(eng, on)
            first = _wave(eng, SPEC_PROMPTS, 24)
            marks = _trace_counts(eng)
            _wave(eng, SPEC_PROMPTS, 24)
            runs.append((first, marks, _trace_counts(eng), _captures(eng),
                         eng.stats["spec_accepted_tokens"],
                         eng.stats["spec_draft_tokens"]))
            _no_drafter_error("agree:graphs", eng)
        (g_tok, m1, m2, caps, acc, drafted), (e_tok, *_rest) = runs
        same = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
        print(f"[agree:graphs] {name} self-draft: graphs == eager {same}; "
              f"accepted {acc}/{drafted}; repeat wave adds no program "
              f"{m1 == m2} {json.dumps(m2)}; captured {json.dumps(caps)}",
              flush=True)
        if not (same and m1 == m2 and caps.get("verify")
                and caps.get("draft.decode") and drafted > 0):
            bad.append(f"{name} self-draft")

    # weight swaps: in place (programs kept) and moving a parameter
    prompts, kw = chunked
    eng = GenerationEngine(gpu, **kw)
    _wave(eng, prompts, 12)
    marks = _trace_counts(eng)
    w = dict(gpu.named_parameters())[SWAP_PARAM]
    eng.swap_weights(lambda: w.mul_(3.0), tag="b")
    swapped = _wave(eng, prompts, 12)
    kept = _trace_counts(eng) == marks
    fresh = _wave(GenerationEngine(gpu, **kw), prompts, 12)
    equal = all(np.array_equal(a, b) for a, b in zip(swapped, fresh))

    def move():
        w.data = w.data * (1.0 / 3.0)      # a new tensor: a new address

    eng.swap_weights(move, tag="c")
    moved = _wave(eng, prompts, 12)
    rebuilt = _trace_counts(eng)
    again = _wave(GenerationEngine(gpu, **kw), prompts, 12)
    print(f"[agree:graphs] swap_weights in place: programs kept {kept}, "
          f"tokens == a fresh engine's {equal}; a moved parameter: "
          f"programs rebuilt {json.dumps(rebuilt)} (before "
          f"{json.dumps(marks)}), tokens == a fresh engine's "
          f"{all(np.array_equal(a, b) for a, b in zip(moved, again))}",
          flush=True)
    if not (kept and equal and all(rebuilt[k] >= 2 * marks[k] for k in marks
                                   if marks[k])
            and all(np.array_equal(a, b) for a, b in zip(moved, again))):
        bad.append("swap_weights")
    if bad:
        raise AssertionError(f"[agree:graphs] failed: {bad}")


MASKED_KERNELS = ("flashmask_attention", "flashmask_attention_bwd",
                  "bias_dropout_residual_ln")
FLASHMASK_SHAPE = (4, 2048, 16, 128)       # [train]'s attention geometry
FLASHMASK_CALLS = 3
FLASHMASK_7B = (1, 8192, 32, 128)          # Llama-2-7B attention, S = 8192


def _profile_calls(tag, call, note):
    """One more call of `call` under torch.profiler: device time by kernel
    and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(tag, prof, wall, note)


def phase_flashmask(K, dev):
    """The flashmask path: F.flashmask_attention through autograd at the
    training geometry [4, 2048, 16, 128] bf16 with a packed-document
    causal mask; a warm-up and FLASHMASK_CALLS timed forward+backward
    calls with the launch counts set to 0 before and read after (each
    call must launch the masked forward and backward once); out and
    grads held against the plain versions. Then the forward at the
    Llama-2-7B width, [1, 8192, 32, 128], beside SDPA with the dense mask,
    its output held against SDPA's within the bf16 attention tolerance.
    Returns the launch counts of the timed calls."""
    from paddle_tpu_torch.nn import functional as F

    _release()
    rng = np.random.default_rng(21)
    b, s, h, d = FLASHMASK_SHAPE
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h,
                                                   "doc")
    del dense
    idx = bounds[0][..., None]           # the document ends, 1 bound
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def call():
        for t in leaves:
            t.grad = None
        out = F.flashmask_attention(*leaves, idx, causal=True)
        out.backward(do)
        return out

    call()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FLASHMASK_CALLS):
        out = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FLASHMASK_CALLS
    launches = K.launch_counts()
    # the plain versions round P and dS where the tensor-core kernels do;
    # the plain backward takes the kernel's out and lse, as in [kernels]
    bf16 = torch.bfloat16
    want_out, _ = K.flashmask_attention_fwd_plain(q, k, v, *bounds,
                                                  causal=True, p_dtype=bf16)
    k_out, k_lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=True)
    want = K.flashmask_attention_bwd_plain(q, k, v, k_out, k_lse, do,
                                           *bounds, causal=True,
                                           p_dtype=bf16)
    out_err = _max_err(out.detach(), want_out)
    rule = _grad_rule([t.grad for t in leaves], want, _rounding_terms(
        K, q, k, v, k_out, k_lse, do, True, bounds))
    grads_ok, grads_rule = _within("flashmask_attention_bwd", rule, bf16)
    print(f"[flashmask] F.flashmask_attention fwd+bwd [{b}, {s}, {h}, {d}] "
          f"bf16, packed documents (lengths 64-1024), causal, "
          f"{pairs} visible pairs: ms_per_call={ms:.3f} (host clock, "
          f"{FLASHMASK_CALLS} calls) out max_err={out_err:.3e} (<= 2e-2) "
          f"dq/dk/dv elements beyond 2^-7|want| + 2^-8 rms(want) "
          f"(allowed)=" + "/".join(f"{c}({_over_allowed(n)})" for c, n in
                     zip(rule["over_n"], rule["n"])) + " share="
          + "/".join(f"{o:.2e}" for o in rule["over"]) +
          " err/(that + 2^-7 sum|terms|)="
          + "/".join(f"{w:.3f}" for w in rule["bound"]) +
          f" ({grads_rule})" +
          f" launches {json.dumps({n: launches[n] for n in MASKED_KERNELS})}"
          f" tensor-core route "
          f"{json.dumps({n: launches[n + '.sm90'] for n in MASKED_KERNELS[:2]})}",
          flush=True)
    if out_err > TOL[bf16] or not grads_ok:
        raise AssertionError("[flashmask] the path's out or grads disagree "
                             "with the plain versions")
    _profile_calls("profile:flashmask", call, "one forward+backward call")
    for n in ("flashmask_attention", "flashmask_attention_bwd"):
        if launches[n] != FLASHMASK_CALLS or \
                launches[f"{n}.sm90"] != FLASHMASK_CALLS:
            raise AssertionError(f"[flashmask] {n} launched {launches[n]} "
                                 f"times ({launches[f'{n}.sm90']} on the "
                                 f"tensor-core route) in {FLASHMASK_CALLS} "
                                 f"calls")
    del out, want, want_out, k_out, k_lse, leaves, q, k, v, do
    _release()

    # Llama-2-7B attention width at S = 8192 (no plain version: its float32
    # score tensors alone would be 8.6 GB each)
    b, s, h, d = FLASHMASK_7B
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h,
                                                   "doc")
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    got, _ = K.flashmask_attention_fwd(q, k, v, *bounds, causal=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = sdpa(qt, kt, vt, attn_mask=dense).transpose(1, 2)
    err = _max_err(got, ref)
    k_ms = _time_ms(lambda: K.flashmask_attention_fwd(q, k, v, *bounds,
                                                      causal=True), 5)
    l_ms = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense), 5)
    bound, by = _bound_ms((4 * q.numel()) * 2 + _bounds_bytes(bounds),
                          4 * d * pairs, torch.bfloat16)
    print(f"[flashmask] 7B width [{b}, {s}, {h}, {d}] bf16, packed documents: "
          f"{pairs} visible pairs; kernel_ms={k_ms:.4f} sdpa_dense_mask_ms="
          f"{l_ms:.4f} bound_ms={bound:.4f} ({by}); max_abs_err vs SDPA="
          f"{err:.3e} (<= 2e-2)", flush=True)
    if err > TOL[torch.bfloat16]:
        raise AssertionError("[flashmask] the 8192 forward disagrees with "
                             "SDPA")
    return launches


FFN_SHAPE = (32, 512, 768, 3072)           # BERT-base: hidden 768, FFN 3072
FFN_CALLS = 5


def phase_fused_ffn(K, dev):
    """The fused FFN path at BERT-base width (bert.py:13): fused_feedforward
    post-norm on [32, 512, 768] bf16, gelu, dropout1 = dropout2 = 0.1,
    ln_epsilon 1e-12, training; forward and backward, a warm-up and
    FFN_CALLS timed calls; bdrln must launch once per call. Then the
    FusedBiasDropoutResidualLayerNorm layer at the same shape. One more
    call is held against the plain versions on the same inputs: the same
    ops replayed from the same generator state with the plain bdrln in
    place of the kernel. The path's output must equal the kernel's on the
    replay's pre-LN tensor bit for bit (so dropout1, GELU, the bias, the
    residual and the seed are the path's), the kernel's there the plain
    bdrln's within one bf16 ulp plus 2^-16 (|n w| + |b| + |w|), and every
    input's gradient the replay's within 1e-2 of its norm (the replay's
    LayerNorm backward differentiates the float32 y, the path's the y
    saved in bf16: ~0.5% apart). The |w| term is new against [kernels]'
    rule: n = (y - mean) / std is near 0 where y ~ mean, the two sides'
    float32 means (summed in other orders) differ by ~1e-7 absolute, and
    LN2's b is 0 here, so |b| gives no slack. Returns the launch counts of
    the timed fused_feedforward calls."""
    from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
    from paddle_tpu_torch.framework.random import next_seed
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F

    _release()
    b, s, h, f = FFN_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(
            torch.bfloat16).requires_grad_()

    x = rnd(b, s, h)
    w1, w2 = rnd(h, f, std=0.02), rnd(f, h, std=0.02)
    b1, b2 = rnd(f, std=0.02), rnd(h, std=0.02)
    s2 = torch.ones(h, device=dev, dtype=torch.bfloat16, requires_grad=True)
    c2 = torch.zeros(h, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn((b, s, h), generator=gen, device=dev).to(torch.bfloat16)

    def call():
        out = IF.fused_feedforward(
            x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln2_scale=s2,
            ln2_bias=c2, dropout1_rate=0.1, dropout2_rate=0.1,
            activation="gelu", ln_epsilon=1e-12, pre_layer_norm=False,
            training=True)
        out.backward(g)
        return out

    call()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FFN_CALLS):
        out = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FFN_CALLS
    launches = K.launch_counts()
    print(f"[fused_ffn] fused_feedforward post-norm [{b}, {s}, {h}] -> {f} "
          f"bf16, gelu, dropout 0.1/0.1, eps 1e-12, training, fwd+bwd: "
          f"ms_per_call={ms:.3f} (host clock, {FFN_CALLS} calls); "
          f"bias_dropout_residual_ln launches="
          f"{launches['bias_dropout_residual_ln']}", flush=True)
    if launches["bias_dropout_residual_ln"] != FFN_CALLS:
        raise AssertionError("[fused_ffn] bdrln did not launch once per "
                             "call")
    _profile_calls("profile:fused_ffn", call, "one forward+backward call")

    params = (x, w1, w2, b1, b2, s2, c2)
    dgen = torch.Generator(device=dev)

    def held(plain):
        """(out, grads, the kernel's out on the replay's pre-LN tensor):
        the path, or the replay of its ops with the plain bdrln."""
        dgen.manual_seed(1)
        for t in params:
            t.grad = None
        if not plain:
            o = IF.fused_feedforward(
                x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln2_scale=s2,
                ln2_bias=c2, dropout1_rate=0.1, dropout2_rate=0.1,
                activation="gelu", ln_epsilon=1e-12, pre_layer_norm=False,
                training=True, generator=dgen)
            o.backward(g)
            return o.detach().float(), [t.grad.float() for t in params], None
        hid = torch.nn.functional.gelu(F.linear(x, w1, b1),
                                       approximate="tanh")
        hid = F.dropout(hid, 0.1, training=True, generator=dgen)
        pre = torch.matmul(hid, w2)
        seed = next_seed(dgen)
        o = K.bias_dropout_residual_ln_plain(pre, x, s2, c2, b2, 1e-12, 0.1,
                                             seed)[0]
        o.backward(g)
        kern = K.bias_dropout_residual_ln(
            *(t.detach() for t in (pre, x, s2, c2, b2)), 1e-12, 0.1, seed)[0]
        return (o.detach().float(), [t.grad.float() for t in params],
                kern.float())

    got, got_grads, _ = held(plain=False)
    want, want_grads, kern = held(plain=True)
    same_pre = torch.equal(got, kern)
    c2f, s2f = c2.detach().float(), s2.detach().float()
    allow = _ulp_bf16(want) + 2.0 ** -16 * (
        (want - c2f).abs() + c2f.abs() + s2f.abs())
    worst = float(((kern - want).abs() / allow).max())
    grad_rel = [float((a - w).norm() / w.norm())
                for a, w in zip(got_grads, want_grads)]
    print(f"[fused_ffn] held against the plain replay: out equal to the "
          f"kernel on the replay's pre-LN tensor: {same_pre}; kernel vs "
          f"plain bdrln there max_abs_err={_max_err(kern, want):.3e} worst "
          f"err/allowed={worst:.3f}; grads' |got - want| / |want| (x, w1, "
          f"w2, b1, b2, ln2 scale, ln2 bias)="
          + ", ".join(f"{r:.2e}" for r in grad_rel), flush=True)
    if not (same_pre and worst <= 1.0 and all(r <= 1e-2 for r in grad_rel)):
        raise AssertionError("[fused_ffn] the path disagrees with the plain "
                             "replay on the same inputs")

    layer = FusedBiasDropoutResidualLayerNorm(h, dropout_rate=0.1,
                                              epsilon=1e-12, device=dev,
                                              dtype=torch.bfloat16)
    xr, res = rnd(b, s, h), rnd(b, s, h)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FFN_CALLS):
        o = layer(xr, res)
        o.backward(g)
    torch.cuda.synchronize()
    lms = (time.perf_counter() - t0) * 1e3 / FFN_CALLS
    n = K.launch_counts()["bias_dropout_residual_ln"]
    print(f"[fused_ffn] FusedBiasDropoutResidualLayerNorm({h}) [{b}, {s}, "
          f"{h}] bf16, p 0.1, fwd+bwd: ms_per_call={lms:.3f}; "
          f"bias_dropout_residual_ln launches={n}", flush=True)
    if n != FFN_CALLS or not bool(torch.isfinite(o).all()):
        raise AssertionError("[fused_ffn] the layer did not launch bdrln "
                             "once per call, or its output is not finite")
    return launches


# [train]: the config bench.py trains on the TPU (bench.py:150-154), at
# full width and depth: a 0.74B Llama, batch 4 x 2048, bf16 parameters,
# AdamW(1e-4, multi_precision=True)
TRAIN_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=12, num_attention_heads=16,
                 num_key_value_heads=16, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
# launches of each kernel in one training step of TRAIN_CFG: two RMSNorms
# per layer and the final one; one RoPE launch per layer each way (q and k
# together), none on the scalar path; every flash launch on the
# tensor-core route (bf16, head dim 128)
TRAIN_PER_STEP = {"flash_attention": 12, "flash_attention_bwd": 12,
                  "flash_attention.sm90": 12, "flash_attention_bwd.sm90": 12,
                  "rms_norm": 25, "swiglu": 12, "fused_rope": 12,
                  "fused_rope.qk": 12, "fused_rope_bwd": 12,
                  "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}


def _train_flops(cfg, n_matmul):
    """(flops of one training step counted from the shapes, formula):
    6 N T for the matmul parameters N (every Linear, the lm_head
    included), attention's 2 forward and 5 backward causal products per
    layer (14 B H D pairs), and the fused loss's recompute of the logits
    in backward (2 T H V)."""
    t = TRAIN_BATCH * TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    pairs = _causal_pairs(TRAIN_SEQ, TRAIN_SEQ)
    attn = 14 * TRAIN_BATCH * cfg.num_attention_heads * hd * pairs * \
        cfg.num_hidden_layers
    loss = 2 * t * cfg.hidden_size * cfg.vocab_size
    total = 6 * n_matmul * t + attn + loss
    formula = (f"6*N*T + 14*B*H*D*pairs*L + 2*T*h*V = 6*{n_matmul}*{t} + "
               f"14*{TRAIN_BATCH}*{cfg.num_attention_heads}*{hd}*{pairs}*"
               f"{cfg.num_hidden_layers} + 2*{t}*{cfg.hidden_size}*"
               f"{cfg.vocab_size} = {total:.4e}")
    return total, formula


def _run_steps(tag, K, step, batch, per_step, n_timed, on_step=None):
    """One warm-up and n_timed timed calls of step(*batch), each timed on
    the host clock around a step that ends in float(loss) (a sync), its
    launches counted and held to per_step ({launch_counts key: launches});
    on_step(i) runs after each step (a scheduler's step). Returns (losses,
    ms per step, the timed steps' summed launches)."""
    losses, ms = [], []
    totals = dict.fromkeys(K.launch_counts(), 0)
    for i in range(n_timed + 1):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(*batch))       # float() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        counts = K.launch_counts()
        bad = {k: counts[k] for k, n in per_step.items() if counts[k] != n}
        if bad:
            raise AssertionError(f"[{tag}] step {i} launched {bad}, "
                                 f"expected {per_step}")
        if i:                            # step 0 is the warm-up
            for k in totals:
                totals[k] += counts[k]
        if on_step is not None:
            on_step(i)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    return losses, ms, totals


def _train_batch(vocab, batch, seq, dev):
    """(ids, labels) [batch, seq] from seed 1: random ids and labels, not
    shifted, as bench.py draws them."""
    rng = np.random.default_rng(1)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(
        dev) for _ in range(2))


def phase_train(K, dev):
    """TRAIN_CFG with random weights from seed 0 and a fixed batch from
    seed 1 (random ids and labels, not shifted, as bench.py draws them):
    one warm-up step and TRAIN_STEPS timed steps of compile_train_step.
    Every loss must be finite and the last below the first; each step must
    launch the kernels TRAIN_PER_STEP times. Returns (launch counts over
    the timed steps, model, optimizer, batch, {losses, step_ms, peak_gb}
    for [train:remat] to hold itself against)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _release()
    cfg = LlamaConfig(**TRAIN_CFG)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    step, opt = _train_step(model, 1e-4, multi_precision=True)
    ids, lab = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    losses, ms, totals = _run_steps("train", K, step, (ids, lab),
                                    TRAIN_PER_STEP, TRAIN_STEPS)
    timed = ms[1:]
    step_ms = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, formula = _train_flops(cfg, n_params - n_embed)
    print(f"[train] bench.py:150 config: hidden {cfg.hidden_size}, ffn "
          f"{cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size}; "
          f"params={n_params} bf16 (matmul N={n_params - n_embed}); batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}; AdamW(1e-4, multi_precision=True)")
    print(f"[train] losses (warm-up first) {losses}")
    print(f"[train] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={tokens / step_ms * 1e3:.1f} "
          f"peak_mem_gb={peak:.2f}")
    print(f"[train] flops/step {formula}; MFU={flops / (step_ms / 1e3) / 989e12:.4f}"
          f" (of 989 TFLOP/s bf16 dense)")
    print(f"[train] launches per step {json.dumps(TRAIN_PER_STEP)} (held "
          f"every step)", flush=True)
    _time_loss(model, dev)
    base = {"losses": losses, "step_ms": step_ms, "peak_gb": peak}
    return totals, model, opt, (ids, lab), base


def _time_loss(model, dev):
    """The fused linear cross-entropy alone at the step's shape (hidden
    [8192, 2048] bf16 against the [2048, 32000] lm_head, chunks of 4096,
    float32 products): forward and backward, CUDA events."""
    from paddle_tpu_torch.nn import functional as F

    t = TRAIN_BATCH * TRAIN_SEQ
    w = model.lm_head.weight
    hid = torch.randn(t, w.shape[0], device=dev, dtype=w.dtype,
                      requires_grad=True)
    lab = torch.randint(0, w.shape[1], (t,), device=dev)

    def run():
        F.fused_linear_cross_entropy(hid, w, lab).backward()

    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(3):
        run()
    e1.record()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    ms = e0.elapsed_time(e1) / 3
    f = 8 * t * w.shape[0] * w.shape[1]
    print(f"[train] fused loss fwd+bwd alone: {ms:.2f} ms for {f:.3e} "
          f"float32 flops (4 products of 2*T*h*V) = "
          f"{f / ms / 1e9:.1f} TFLOP/s", flush=True)


def phase_profile_train(model, opt, batch):
    """One more training step under torch.profiler, written out as
    compile_train_step runs it: device time by kernel and by kind, the
    device's idle share of the step's wall time, and the split of the step
    into forward+loss, backward and optimizer (CUDA events around each)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ids, lab = batch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        loss = model(ids, labels=lab)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.clear_grad()
        ev[3].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phases = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
              enumerate(("forward+loss", "backward", "optimizer"))}
    print(f"[profile:train] phases (CUDA events, ms) "
          f"{json.dumps({k: round(v, 2) for k, v in phases.items()})}")
    _print_profile("profile:train", prof, wall, "one training step")
    kinds = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0) + us
    busy = sum(kinds.values()) or 1
    print("[profile:train] by kind: " + ", ".join(
        f"{k} {v / 1e3:.2f} ms ({100 * v / busy:.1f}%)"
        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
        flush=True)


def _kernel_kind(name):
    """Kind of a device kernel by its name: the port's kernels by their
    CUDA names, cuBLAS products split by operand type (the fused loss's
    products are the float32 ones), the rest as PyTorch's own."""
    n = name.lower()
    for key, kind in (("flash_bwd", "flash backward"),
                      ("flash_dq", "flash backward"),
                      ("flash_dkv", "flash backward"),
                      ("flash_fwd", "flash forward"),
                      ("rms_norm", "rmsnorm"), ("swiglu", "swiglu"),
                      ("rope", "rope")):
        if key in n:
            return kind
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return ("GEMM float32 (loss)" if any(k in n for k in (
            "f32f32", "sgemm", "tf32", "_s1688", "fp32")) else "GEMM bf16")
    return "other (elementwise, reductions, optimizer, copies)"


def _serving_model(dev):
    """Llama-2-7B geometry, all 32 layers, bfloat16, random weights from
    seed 0."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] llama2_7b geometry, layers={cfg.num_hidden_layers}, "
          f"params={n_params / 1e9:.3f}B bf16, init_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    return model


def _fresh_pools(model):
    """Drop the previous runs' engines (and their KV pools; a profiled
    engine may sit in a reference cycle until the collector runs)."""
    model.__dict__.pop("_engines", None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _print_twin_diff(tag, gen, twin):
    """The share of generated tokens that differ from the bf16 twin run's
    (printed, not checked: random weights give no accuracy to hold)."""
    if twin is None:
        return
    diff = sum(int(np.count_nonzero(a != b)) for a, b in zip(gen, twin))
    total = sum(len(a) for a in gen)
    first = [int(np.argmax(a != b)) if np.any(a != b) else len(a)
             for a, b in zip(gen, twin)]
    print(f"[{tag}] generated tokens differing from the bf16 run: "
          f"{diff}/{total} = {diff / total:.4f}; first differing position "
          f"per request {first}")


def _serve_wave(eng, prompts, n_new):
    """One timed wave of the workload through a (reused) engine, the
    prefix index dropped first so that a repeat wave has the first one's
    shapes. Returns (generated tokens, the wave's stats (counters as
    deltas, "engine_steps" added), wall seconds, kernel launches, ttft
    seconds)."""
    from paddle_tpu_torch.ops import kernels as K

    before = dict(eng.stats, spec_fallbacks=dict(eng.stats["spec_fallbacks"]))
    n_ttft = len(eng.ttft_s)
    eng.blocks.invalidate_index()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng._submit(p, n_new, 0.0, None, 0, None) for p in prompts]
    n_steps = 0
    with torch.inference_mode():
        while eng.has_work():
            eng.step()
            n_steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = {k: (v - before[k] if isinstance(v, (int, float)) and
              not isinstance(v, bool) and k != "kv_pool_bytes" else v)
          for k, v in eng.stats.items()}
    st["spec_fallbacks"] = {
        r: n - before["spec_fallbacks"].get(r, 0)
        for r, n in eng.stats["spec_fallbacks"].items()
        if n - before["spec_fallbacks"].get(r, 0)}
    st["engine_steps"] = n_steps
    ttft = sorted(list(eng.ttft_s)[n_ttft:])
    # a preemption folds generated tokens into the prompt
    gen = [np.concatenate([r.prompt, np.asarray(r.out, np.int32)])[len(p):]
           for r, p in zip(reqs, prompts)]
    return gen, st, wall, launches, ttft


def phase_serve(K, model, kv_dtype=None, twin=None, name="serve"):
    """8 requests of 300-900 tokens (requests 0 and 5 share a 512-token
    prefix), 32 greedy tokens each, on float pools or (kv_dtype="int8")
    int8 pools, through one engine whose step programs are CUDA graphs: a
    cold wave (each program's first use runs eagerly and captures it),
    then a warm wave of the same shapes (replays only: it must build no
    program) whose numbers stand for the run, and a third wave with engine
    steps PROFILE_STEPS under torch.profiler. Then the eager twin
    (``_graphs = False``) on a fresh engine: a timed wave, which must
    give the warm wave's tokens and kernel launches, and a profiled one.
    Returns the warm wave's kernel launches, generated tokens and stats.
    `name` tags the lines ([name], [name:int8], [profile:name...])."""
    from paddle_tpu_torch.inference import GenerationEngine

    cfg = model.config
    tag = name if kv_dtype is None else f"{name}:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    n_new = 32
    eng = GenerationEngine(model, **kw)
    _, cold, cold_wall, _, _ = _serve_wave(eng, prompts, n_new)
    marks = _trace_counts(eng)
    gen, st, wall, launches, ttft = _serve_wave(eng, prompts, n_new)
    frozen = _trace_counts(eng) == marks
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] CUDA graphs: cold wave wall_s={cold_wall:.3f} (decode "
          f"tokens_per_s="
          f"{cold['decode_tokens'] / max(cold['decode_s'], 1e-9):.2f}, "
          f"captures included); programs captured "
          f"{json.dumps(_captures(eng))}; warm wave builds none: {frozen} "
          f"{json.dumps(_trace_counts(eng))}")
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb={peak:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']} (warm wave, graphs)")
    print(f"[{tag}] ttft_s p50={ttft[len(ttft) // 2]:.4f} "
          f"max={ttft[-1]:.4f} (host clock, from submission)")
    print(f"[{tag}] decode chunks={st['decode_chunks']} tokens="
          f"{st['decode_tokens']} tokens_per_s="
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.2f}; "
          f"ragged steps={st['ragged_steps']} s={st['ragged_s']:.3f} "
          f"mixed_decode_tokens={st['mixed_decode_tokens']}")
    print(f"[{tag}] prefix_hits={st['prefix_hits']} hit_tokens="
          f"{st['prefix_hit_tokens']} preemptions={st['preemptions']}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _print_decode_launches(tag, K, launches, eng, kv_dtype)
    if _is_llama(model):
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
    _print_twin_diff(tag, gen, twin)
    for g in gen:
        if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError(f"[{tag}] a result is not prompt + "
                                 f"{n_new} tokens of the vocabulary")
    if len(set(np.concatenate(gen).tolist())) < 2:
        raise AssertionError("degenerate output: one token everywhere")
    if st["prefix_hits"] < 1:
        raise AssertionError("the serving run saw no prefix-cache hit")
    _require_launched(tag, launches, _path_kernels(model, kv_dtype, False))
    if kv_dtype is not None:
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _require_sm90_ragged(tag, launches)
    if not frozen:
        raise AssertionError(f"[{tag}] the warm wave built programs")
    steps = st["engine_steps"]
    _profile_serve(eng, prompts, n_new, f"profile:{tag}")
    del eng
    _fresh_pools(model)

    # the eager twin
    twin_eng = GenerationEngine(model, **kw)
    twin_eng._graphs = False
    e_gen, e_st, e_wall, e_launches, _ = _serve_wave(twin_eng, prompts,
                                                     n_new)
    e_peak = torch.cuda.max_memory_allocated() / 1e9
    same = all(np.array_equal(a, b) for a, b in zip(gen, e_gen))
    print(f"[{tag}:eager] the eager twin (_graphs = False): wall_s="
          f"{e_wall:.3f} peak_mem_gb={e_peak:.2f} decode tokens_per_s="
          f"{e_st['decode_tokens'] / max(e_st['decode_s'], 1e-9):.2f} "
          f"ragged s={e_st['ragged_s']:.3f}; tokens == graphs' {same}; "
          f"kernel launches == graphs' {e_launches == launches} ("
          f"per engine step "
          f"{sum(launches[k] for k in K.KERNELS) / max(steps, 1):.1f} "
          f"wrapper launches over {steps} engine steps)", flush=True)
    if not same or e_launches != launches:
        raise AssertionError(f"[{tag}] graphs and the eager twin disagree "
                             "(tokens or kernel launches)")
    _profile_serve(twin_eng, prompts, n_new, f"profile:{tag}:eager")
    del twin_eng
    _fresh_pools(model)
    return launches, gen, st


def _is_llama(model):
    return hasattr(model, "llama")


def _path_kernels(model, kv_dtype, dense):
    """The kernels a serving run's path launches: decode attention, and
    ragged attention (chunked prefill) or flash (dense admission), their
    int8 twins over int8 pools; the Llama's layers add RMSNorm, SwiGLU and
    RoPE (GPT's LayerNorm, GELU and learned positions are plain)."""
    suffix = "" if kv_dtype is None else "_int8"
    out = (("flash_attention",) if dense else
           (f"ragged_paged_attention{suffix}",)) + \
        (f"paged_decode_attention{suffix}",)
    if _is_llama(model):
        out += ("rms_norm", "swiglu", "fused_rope")
    return out

# what an int8 run must never launch: no float pool behind the flag
FLOAT_PAGED_KERNELS = ("ragged_paged_attention", "paged_decode_attention")
RAGGED_KERNELS = ("ragged_paged_attention", "ragged_paged_attention_int8")


def _print_decode_launches(tag, K, launches, eng, kv_dtype):
    """Decode attention's wrapper calls over the run, the decode steps they
    make (one call a layer a step), the split plan at the engine's shapes
    and the CUDA launches that gives each decode step (split kernel, and
    the merge when there is more than one split)."""
    cfg = eng.model.config
    name = ("paged_decode_attention" if kv_dtype is None
            else "paged_decode_attention_int8")
    layers = cfg.num_hidden_layers
    p_max = eng.blocks.block_tables.shape[1]
    splits, pps = K.split_plan(eng.max_slots, cfg.num_attention_heads,
                               eng.model.paged_spec()["n_kv_heads"], p_max,
                               eng.page_size)
    per_call = 1 + (splits > 1)
    print(f"[{tag}] decode attention: {launches[name]} calls = "
          f"{launches[name] // layers} decode steps x {layers} layers; plan "
          f"at B={eng.max_slots}, table width {p_max}: splits={splits} "
          f"pages_per_split={pps}; CUDA launches per call {per_call}, per "
          f"decode step {per_call * layers}", flush=True)


# a kernel launched once per layer by every model step: paged decode,
# ragged, or dense admission (flash)
STEP_KERNELS = ("paged_decode_attention", "paged_decode_attention_int8",
                "ragged_paged_attention", "ragged_paged_attention_int8",
                "flash_attention")


def _check_rope_launches(tag, launches, layers):
    """RoPE's launches per model step (a decode step, a ragged step or a
    dense admission; an engine step's decode chunk makes several decode
    steps): one q + k launch per layer, on the vector path."""
    steps = sum(launches[n] for n in STEP_KERNELS) // layers
    n = launches["fused_rope"]
    print(f"[{tag}] RoPE: {n} launches ({launches['fused_rope.qk']} of q "
          f"and k together, {launches['fused_rope.scalar']} on the scalar "
          f"path) over {steps} model steps = {n / max(steps, 1):g} per "
          f"model step (one per layer: {layers})", flush=True)
    if n != layers * steps or launches["fused_rope.qk"] != n or \
            launches["fused_rope.scalar"]:
        raise AssertionError(f"[{tag}] RoPE launches {n} (q+k "
                             f"{launches['fused_rope.qk']}, scalar "
                             f"{launches['fused_rope.scalar']}), expected "
                             f"{layers} per model step x {steps} steps, all "
                             f"q+k on the vector path")


def _require_launched(tag, launches, names):
    idle = [k for k in names if launches[k] <= 0]
    if idle:
        raise AssertionError(f"[{tag}] kernels never launched on the path: "
                             f"{idle}")


def _require_sm90_ragged(tag, launches):
    """Every ragged launch of a bfloat16 serving run (float or int8 pages
    of 16, head dim 128) took the tensor-core route."""
    off = {n: (launches[n], launches[f"{n}.sm90"]) for n in RAGGED_KERNELS
           if launches[f"{n}.sm90"] != launches[n]}
    if off:
        raise AssertionError(f"[{tag}] ragged launches off the tensor-core "
                             f"route (launches, sm90): {off}")


def _require_idle(tag, launches, names):
    busy = {k: launches[k] for k in names if launches[k] != 0}
    if busy:
        raise AssertionError(f"[{tag}] float paged kernels launched in an "
                             f"int8 run: {busy}")


def phase_serve_dense(K, model, kv_dtype=None, twin=None,
                      name="serve:dense"):
    """The same model serves 8 cold requests of 64-256 tokens (no shared
    prefix), 32 greedy tokens each: every prompt fits the chunk of 256, so
    the engine admits them through the dense prefill. A cold wave captures
    the programs; the numbers are the warm wave's (replays, the same
    shapes); the first admission of a third wave is profiled. Then the
    eager twin (``_graphs = False``) on a fresh engine must give the warm
    wave's tokens and kernel launches. Returns the warm wave's kernel
    launch counts and generated tokens. `name` tags the lines as in
    phase_serve."""
    from paddle_tpu_torch.inference import GenerationEngine

    cfg = model.config
    tag = name if kv_dtype is None else f"{name}:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(64, 257))).astype(np.int32)
               for _ in range(8)]
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              kv_dtype=kv_dtype)
    n_new = 32
    shapes = []                 # (c, s_pad) of every dense admission built
    prefill = model.paged_prefill

    def recorded_prefill(ids, lengths):
        shapes.append(tuple(ids.shape))
        return prefill(ids, lengths)

    model.paged_prefill = recorded_prefill
    eng = GenerationEngine(model, **kw)
    try:
        _serve_wave(eng, prompts, n_new)
        marks = _trace_counts(eng)
        gen, st, wall, launches, ttft = _serve_wave(eng, prompts, n_new)
    finally:
        del model.paged_prefill
    frozen = _trace_counts(eng) == marks
    admits = max(st["prefill_admits"], 1)
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']} (warm wave, graphs; "
          f"programs captured {json.dumps(_captures(eng))}, the warm wave "
          f"builds none: {frozen})")
    print(f"[{tag}] ttft_s p50={ttft[len(ttft) // 2]:.4f} "
          f"max={ttft[-1]:.4f} (host clock, from submission)")
    print(f"[{tag}] prefill_admits={st['prefill_admits']} "
          f"buckets={sorted(set(shapes))} prefill_tokens="
          f"{st['prefill_tokens']} "
          f"prefill_s_per_admit={st['prefill_s'] / admits:.4f}; "
          f"decode chunks={st['decode_chunks']} tokens="
          f"{st['decode_tokens']} tokens_per_s="
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.2f}; "
          f"ragged steps={st['ragged_steps']} "
          f"preemptions={st['preemptions']}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _print_decode_launches(tag, K, launches, eng, kv_dtype)
    if _is_llama(model):
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
    _print_twin_diff(tag, gen, twin)
    for g in gen:
        if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError(f"[{tag}] a result is not prompt + "
                                 f"{n_new} tokens of the vocabulary")
    if st["prefill_admits"] < 2 or not shapes or shapes[0] != (4, 256):
        raise AssertionError(f"expected >= 2 dense admissions, the first "
                             f"with (c, s_pad) = (4, 256); got "
                             f"{st['prefill_admits']}, {shapes}")
    if not frozen:
        raise AssertionError(f"[{tag}] the warm wave built programs")
    _require_launched(tag, launches, _path_kernels(model, kv_dtype, True))
    if kv_dtype is not None:
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _require_sm90_ragged(tag, launches)
    # one flash forward per layer and admission, on the tensor-core route
    want = cfg.num_hidden_layers * st["prefill_admits"]
    if launches["flash_attention"] != want or \
            launches["flash_attention.sm90"] != want:
        raise AssertionError(f"[{tag}] flash launches "
                             f"{launches['flash_attention']} (tensor-core "
                             f"route {launches['flash_attention.sm90']}), "
                             f"expected {want}")
    _profile_admission(eng, prompts, n_new,
                       "profile:" + tag[len("serve:"):])
    del eng
    _fresh_pools(model)

    twin_eng = GenerationEngine(model, **kw)
    twin_eng._graphs = False
    e_gen, e_st, e_wall, e_launches, _ = _serve_wave(twin_eng, prompts,
                                                     n_new)
    same = all(np.array_equal(a, b) for a, b in zip(gen, e_gen))
    print(f"[{tag}:eager] the eager twin (_graphs = False): wall_s="
          f"{e_wall:.3f} prefill_s_per_admit="
          f"{e_st['prefill_s'] / max(e_st['prefill_admits'], 1):.4f} "
          f"decode tokens_per_s="
          f"{e_st['decode_tokens'] / max(e_st['decode_s'], 1e-9):.2f}; "
          f"tokens == graphs' {same}; kernel launches == graphs' "
          f"{e_launches == launches}", flush=True)
    if not same or e_launches != launches:
        raise AssertionError(f"[{tag}] graphs and the eager twin disagree "
                             "(tokens or kernel launches)")
    del twin_eng
    _fresh_pools(model)
    return launches, gen


# the kernels a speculative serving run must launch (its decode rows ride
# the verify windows of the ragged kernel; the plain decode kernel serves
# fallback chunks and the draft model's steps)
SPEC_KERNELS = ("ragged_paged_attention", "rms_norm", "swiglu", "fused_rope")
SPEC_INT8_KERNELS = ("ragged_paged_attention_int8", "rms_norm", "swiglu",
                     "fused_rope")
# a first divergence from the spec-off twin is a near-tie when the dense
# forward over the common prefix scores the two candidate tokens within
# this many bf16 ulps (at the larger of the two logits) of each other:
# twice the worst gap measured on the H100 (bf16 pools 4 ulps, int8 pools
# 11: their KV carries the int8 rounding the dense forward does not)
SPEC_TIE_ULPS = {None: 8.0, "int8": 24.0}


def _model_steps(st):
    """Model steps (one launch of every layer) an engine's stats record."""
    return (st["prefill_admits"] + st["ragged_steps"] + st["decode_steps"]
            + st["spec_dispatches"])


def _first_divergences(tag, model, prompts, gen, twin, kv_dtype):
    """Each request's tokens against its spec-off twin: at a first
    divergence, the dense forward over the common prefix scores both
    candidates, which must lie within SPEC_TIE_ULPS bf16 ulps."""
    found = []
    for i, (p, a, b) in enumerate(zip(prompts, gen, twin)):
        neq = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if not neq.size:
            continue
        t = int(neq[0])
        ids = torch.as_tensor(np.concatenate([p, a[:t]])[None],
                              dtype=torch.long, device=model.device)
        with torch.inference_mode():
            logits = model(ids)[0, -1].float()
        la, lb = float(logits[int(a[t])]), float(logits[int(b[t])])
        ulp = 2.0 ** (math.floor(math.log2(max(abs(la), abs(lb), 1e-30)))
                      - 7)
        found.append((i, t, la, lb, abs(la - lb) / ulp,
                      float(logits.max())))
    worst = max((f[4] for f in found), default=0.0)
    print(f"[{tag}] first divergences from the spec-off twin: {len(found)} "
          f"of {len(prompts)} requests, (request, position) "
          f"{[(f[0], f[1]) for f in found]}; dense-forward logits of the "
          f"two candidates (spec-on, spec-off, gap in bf16 ulps, row max) "
          f"{[(round(f[2], 4), round(f[3], 4), round(f[4], 2), round(f[5], 3)) for f in found]}; "
          f"worst gap {worst:.2f} ulps (allowed "
          f"{SPEC_TIE_ULPS[kv_dtype]:g})", flush=True)
    if worst > SPEC_TIE_ULPS[kv_dtype]:
        raise AssertionError(f"[{tag}] a divergence from the spec-off twin "
                             f"is no near-tie: {worst:.2f} ulps")
    return found


def _copying_prompts(model, kw, rng, n, length, rounds=3):
    """n random prompts of `length` tokens that hold their own next token:
    the engine (spec off) generates each prompt's first token, which is
    written into the prompt at its middle, `rounds` times at successive
    positions (a substitution can move the next token; each round writes
    the new one), so that the n-gram drafter finds the first generated
    token in the context and proposes what followed it. On random weights
    greedy text never repeats its context (32 tokens after prompts of a
    repeated segment: no n-gram hit), so prompts that merely repeat give
    the drafter nothing to draft."""
    from paddle_tpu_torch.inference import GenerationEngine

    vocab = model.config.vocab_size
    prompts = [rng.integers(1, vocab, length).astype(np.int32)
               for _ in range(n)]
    eng = GenerationEngine(model, **kw)
    for r in range(rounds):
        first = [int(g[0]) for g in _serve_wave(eng, prompts, 1)[0]]
        for p, t in zip(prompts, first):
            p[length // 2 + r] = t
    del eng
    return prompts


def phase_serve_spec(K, model, twin, twin_st, kv_dtype=None):
    """Speculative decoding at 7B with the step programs as CUDA graphs,
    each run a cold wave (captures) and then a warm wave of the same
    shapes, whose numbers stand for it: first self-drafting
    (DraftModelDrafter over the serving model itself, with pools like the
    target's) on the [serve] workload (the same 8 requests of 300-900
    tokens, 32 greedy tokens each), beside the [serve] warm wave (the
    spec-off twin, graphs too); then the n-gram drafter on prompts that
    hold their own next token (_copying_prompts), beside their own
    spec-off run, which must draft. Each run prints the spec accounting,
    drafting and verify ms per dispatch, dispatches and launches per
    generated token and the decode throughput beside its twin's, and the
    peak memory. A drafter error fails the phase; the verify windows must
    take the tensor-core ragged route; an int8 run must launch no float
    paged kernel; each request's first divergence from its twin must be a
    near-tie. Returns the kernel launch counts over the runs' warm
    waves."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine

    cfg = model.config
    base = "serve:spec" if kv_dtype is None else "serve:spec:int8"
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    n_new = 32
    total = dict.fromkeys(K.launch_counts(), 0)
    for drafter in ("draft_model", "ngram"):
        tag = f"{base}:{drafter}"
        if drafter == "draft_model":
            rng = np.random.default_rng(0)
            prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size,
                                       512, (0, 5))
            off_gen, off_st = twin, twin_st
        else:
            _fresh_pools(model)
            prompts = _copying_prompts(model, kw, np.random.default_rng(6),
                                       8, 1024)
            off = GenerationEngine(model, **kw)
            _serve_wave(off, prompts, n_new)
            off_gen, off_st = _serve_wave(off, prompts, n_new)[:2]
            del off
        n_gen = n_new * len(prompts)
        twin_tps = off_st["decode_tokens"] / max(off_st["decode_s"], 1e-9)
        twin_steps = _model_steps(off_st)
        _fresh_pools(model)
        spec = DraftModelDrafter(model, kv_dtype=kv_dtype) \
            if drafter == "draft_model" else "ngram"
        eng = GenerationEngine(model, spec_decode=spec, **kw)
        _serve_wave(eng, prompts, n_new)
        marks = _trace_counts(eng)
        inner = getattr(eng._spec, "_eng", None)
        d_before = None if inner is None else dict(inner.stats)
        gen, st, wall, launches, _ = _serve_wave(eng, prompts, n_new)
        frozen = _trace_counts(eng) == marks
        for k in total:
            total[k] += launches[k]
        d_steps = 0 if inner is None else sum(
            inner.stats[k] - d_before[k]
            for k in ("ragged_steps", "decode_steps"))
        disp = max(st["spec_dispatches"], 1)
        tps = (st["spec_tokens"] + st["decode_tokens"]) / max(
            st["spec_verify_s"] + st["spec_draft_s"] + st["decode_s"], 1e-9)
        n_launch = sum(launches[k] for k in K.KERNELS)
        steps = _model_steps(st)
        print(f"[{tag}] requests={len(prompts)} new_tokens="
              f"{sum(map(len, gen))} wall_s={wall:.3f} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"kv_pool_bytes={st['kv_pool_bytes']}"
              + ("" if inner is None else
                 f" + the draft engine's {inner.stats['kv_pool_bytes']}")
              + f" (warm wave, graphs; captured "
              f"{json.dumps(_captures(eng))}; the warm wave builds none: "
              f"{frozen})")
        print(f"[{tag}] verify dispatches={st['spec_dispatches']} "
              f"drafted={st['spec_draft_tokens']} accepted="
              f"{st['spec_accepted_tokens']} acceptance="
              f"{st['spec_accepted_tokens'] / max(st['spec_draft_tokens'], 1):.4f}"
              f" rollbacks={st['spec_rollbacks']} fallbacks="
              f"{json.dumps(st['spec_fallbacks'])} tokens_per_verify_dispatch="
              f"{st['spec_tokens'] / disp:.3f} (per row "
              f"{st['spec_tokens'] / max(st['spec_rows'], 1):.3f}, rows "
              f"{st['spec_rows']}) verify_s={st['spec_verify_s']:.3f} "
              f"draft_s={st['spec_draft_s']:.3f} (host clock; per verify "
              f"dispatch {1e3 * st['spec_verify_s'] / disp:.2f} ms of "
              f"verify and {1e3 * st['spec_draft_s'] / disp:.2f} ms of "
              f"drafting)")
        print(f"[{tag}] decode tokens_per_s={tps:.2f} ((verify + plain "
              f"chunk tokens) / (verify + draft + chunk seconds), host "
              f"clock) beside the spec-off twin's {twin_tps:.2f} (graphs "
              f"both); decode chunks={st['decode_chunks']} tokens="
              f"{st['decode_tokens']}; ragged steps={st['ragged_steps']} "
              f"mixed_decode_tokens={st['mixed_decode_tokens']}")
        print(f"[{tag}] model steps per generated token: target "
              f"{steps / n_gen:.4f} (spec-off twin {twin_steps / n_gen:.4f}), "
              f"with the draft model's {(steps + d_steps) / n_gen:.4f}; "
              f"kernel launches per generated token {n_launch / n_gen:.2f}")
        print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
        _no_drafter_error(tag, eng)
        if st["spec_dispatches"] < 1 or st["spec_draft_tokens"] < 1:
            raise AssertionError(f"[{tag}] no verify dispatch drafted "
                                 "anything")
        if not frozen:
            raise AssertionError(f"[{tag}] the warm wave built programs")
        for g in gen:
            if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
                raise AssertionError(f"[{tag}] a result is not prompt + "
                                     f"{n_new} tokens of the vocabulary")
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
        if kv_dtype is None:
            _require_launched(tag, launches, SPEC_KERNELS)
        else:
            _require_launched(tag, launches, SPEC_INT8_KERNELS)
            _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
        _require_sm90_ragged(tag, launches)
        _first_divergences(tag, model, prompts, gen, off_gen, kv_dtype)
        del eng, spec, inner
    _fresh_pools(model)
    return total


def _verify_plain(model, eng, ids, q_lens, start_pos, bt, wpid, woff,
                  p_dtype=None):
    """A verify dispatch's argmaxes [c, s_pad] again, with attention
    through the plain ragged version over a copy of the pages its rows
    read and write (the engine's pools are left as they are): P in
    float32 as the reference's ragged kernel keeps it, or with `p_dtype`
    rounded to that type before the P V product as the tensor-core kernel
    rounds it, every other rounding the plain version's."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels as K

    dev = eng.device
    pages = np.unique(np.concatenate([[0], bt.ravel(), wpid.ravel()]))
    remap = np.zeros(eng.blocks.n_pages, np.int64)
    remap[pages] = np.arange(len(pages))
    idx = torch.as_tensor(pages, device=dev)
    kp = [p[idx] for p in eng.k_pages]
    vp = [p[idx] for p in eng.v_pages]
    scales = {} if eng.k_scales is None else {
        "k_scales": [x[idx] for x in eng.k_scales],
        "v_scales": [x[idx] for x in eng.v_scales]}

    def plain(q, k_pages, v_pages, block_tables, context_lens, q_lens,
              scale=None, k_scales=None, v_scales=None, name=None):
        if k_scales is None:
            return K.ragged_paged_attention_plain(
                q, k_pages, v_pages, block_tables, context_lens, q_lens,
                scale, p_dtype=p_dtype)
        return K.ragged_paged_attention_int8_plain(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            context_lens, q_lens, scale, p_dtype=p_dtype)

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    kernel = F.ragged_paged_attention
    F.ragged_paged_attention = plain
    try:
        with torch.inference_mode():
            logits = model.paged_verify(
                put(ids), put(q_lens), put(start_pos), kp, vp,
                put(remap[bt].astype(np.int32)), put(remap[wpid]),
                put(woff), **scales)[0]
    finally:
        F.ragged_paged_attention = kernel
    return torch.argmax(logits.float(), dim=-1).cpu().numpy()


def phase_spec_rescore(model, kv_dtype=None):
    """[spec:rescore] (ROADMAP C.1): the self-drafting [serve:spec] run
    again (untimed). Each verify dispatch with a rejected draft is
    rescored twice through the plain ragged version (``_verify_plain``):
    with P in float32 (the reference's rounding) and with P rounded to
    the model's type as the tensor-core kernel rounds it, all else equal.
    Printed: the rejections; how many the float32-P rescoring accepts
    (flips against the kernel, which differs from the plain version in
    every rounding); how many decisions, rejections and acceptances, P's
    rounding alone changes (the 16-bit-P rescoring against the float32-P
    one); and the argmaxes over every verify position that differ between
    the two rescorings, and between the kernel and the float32-P one.
    Returns the counts."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine

    cfg = model.config
    tag = "spec:rescore" if kv_dtype is None else "spec:rescore:int8"
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    _fresh_pools(model)
    eng = GenerationEngine(model, spec_decode=DraftModelDrafter(
        model, kv_dtype=kv_dtype), max_slots=4, page_size=16,
        prefill_chunk=256, mixed_step=True, prefix_cache=True,
        kv_dtype=kv_dtype)
    p16 = model.llama.embed_tokens.weight.dtype
    verify = eng._verify_launch
    n = dict.fromkeys(("rejections", "flips", "p_flips", "accepted",
                       "accept_flips", "p_accept_flips", "positions",
                       "p_argmax_diff", "kernel_argmax_diff",
                       "rescored_dispatches"), 0)

    def rescored(ids, q_lens, start_pos, bt, wpid, woff):
        g = verify(ids, q_lens, start_pos, bt, wpid, woff)
        rows = []                           # (row, drafts, accepted)
        for i in range(len(q_lens)):
            m = int(q_lens[i]) - 1
            a = 0
            while a < m and int(ids[i, 1 + a]) == int(g[i, a]):
                a += 1
            if m > 0:
                rows.append((i, m, a))
        if not any(a < m for _, m, a in rows):
            return g
        args = (model, eng, ids, q_lens, start_pos, bt, wpid, woff)
        g32 = _verify_plain(*args)
        g16 = _verify_plain(*args, p_dtype=p16)
        n["rescored_dispatches"] += 1
        for i, m, a in rows:
            draft = [int(t) for t in ids[i, 1:1 + m]]
            ok32 = [int(g32[i, j]) == draft[j] for j in range(m)]
            ok16 = [int(g16[i, j]) == draft[j] for j in range(m)]
            n["accepted"] += a
            n["accept_flips"] += a - sum(ok32[:a])
            n["p_accept_flips"] += sum(x != y for x, y in
                                       zip(ok32[:a], ok16[:a]))
            if a < m:
                n["rejections"] += 1
                n["flips"] += ok32[a]
                n["p_flips"] += ok32[a] != ok16[a]
            n["positions"] += m + 1
            n["p_argmax_diff"] += int((g32[i, :m + 1] != g16[i, :m + 1])
                                      .sum())
            n["kernel_argmax_diff"] += int((g32[i, :m + 1] != g[i, :m + 1])
                                           .sum())
        return g

    eng._verify_launch = rescored
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    with torch.inference_mode():
        eng.run()
    st = eng.stats
    n["acceptance"] = st["spec_accepted_tokens"] / max(
        st["spec_draft_tokens"], 1)
    print(f"[{tag}] verify dispatches={st['spec_dispatches']} drafted="
          f"{st['spec_draft_tokens']} accepted={st['spec_accepted_tokens']} "
          f"(acceptance {n['acceptance']:.4f}); {n['rescored_dispatches']} "
          f"dispatches rescored through the plain version with P in "
          f"float32 and in {str(p16).split('.')[-1]}: rejections="
          f"{n['rejections']}, of which the float32-P rescoring accepts "
          f"(flips against the kernel) {n['flips']} and P's rounding alone "
          f"decides differently {n['p_flips']}; accepted drafts "
          f"{n['accepted']}, of which the float32-P rescoring rejects "
          f"{n['accept_flips']} and P's rounding alone decides differently "
          f"{n['p_accept_flips']}; argmaxes that differ over "
          f"{n['positions']} verify positions: 16-bit P against float32 P "
          f"(plain both) {n['p_argmax_diff']}, the kernel against float32 "
          f"P {n['kernel_argmax_diff']}", flush=True)
    _no_drafter_error(tag, eng)
    if st["spec_rollbacks"] != n["rejections"]:
        raise AssertionError(f"[{tag}] {n['rejections']} rejections seen, "
                             f"the engine counted {st['spec_rollbacks']} "
                             f"rollbacks")
    if n["rescored_dispatches"] < 1:
        raise AssertionError(f"[{tag}] no verify dispatch rejected a draft")
    del eng, verify, rescored
    _fresh_pools(model)
    return n


def _print_profile(tag, prof, wall, note, steps=None):
    """Device time by kernel from a finished torch.profiler window, and
    the device's busy share of the window's wall time; with `steps`, the
    window's engine steps, also its kernel launches per engine step."""
    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # kernel entries only: an operator's own entry repeats the device time
    # of the kernels it launched
    rows = [(dev_us(e), e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = sorted([r for r in rows if r[0] > 0], reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    n_kernels = sum(r[2] for r in rows)
    if not rows:
        print(f"[{tag}] the profiler recorded no device time: device "
              "breakdown not measured")
        return
    # host calls that put work on the card: kernel and graph launches
    # and copies (the CUDA runtime and driver calls the profiler records)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in HOST_LAUNCH_CALLS}
    per = "" if steps is None else (
        f" kernel_launches_per_engine_step={n_kernels / steps:.1f}"
        f" host_launch_calls_per_engine_step="
        f"{sum(calls.values()) / steps:.1f} {json.dumps(calls)}")
    print(f"[{tag}] {note}: wall_s={wall:.3f} device_busy_s={busy:.3f} "
          f"idle_share={1 - busy / wall:.3f} kernel_launches={n_kernels}"
          f"{per}")
    # the paged decode attention kernels (split and merge, float and int8)
    # and the ragged kernels (tensor-core and SIMT)
    dec = [r for r in rows if "decode_" in r[1] and "ptt::" in r[1]]
    if dec:
        print(f"[{tag}] decode attention: "
              f"{sum(r[0] for r in dec) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in dec) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in dec)} launches (the merge's time "
              f"includes its wait on the split kernel)")
    rope = [r for r in rows if "rope_" in r[1]]
    if rope:
        print(f"[{tag}] RoPE: {sum(r[0] for r in rope) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in rope) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in rope)} launches")
    fl = [r for r in rows if "flash_fwd" in r[1]]
    if fl:
        print(f"[{tag}] flash attention: {sum(r[0] for r in fl) / 1e3:.2f} "
              f"ms = {100 * sum(r[0] for r in fl) / 1e6 / busy:.1f}% of "
              f"busy time, {sum(r[2] for r in fl)} launches")
    rag = [r for r in rows if "ragged_" in r[1]]
    if rag:
        print(f"[{tag}] ragged attention: "
              f"{sum(r[0] for r in rag) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in rag) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in rag)} launches "
              f"({', '.join(sorted({r[1].split('<')[0][-40:] for r in rag}))})")
    for us, key, count in rows[:14]:
        print(f"[{tag}] {us / 1e3:10.2f} ms {100 * us / 1e6 / busy:5.1f}% "
              f"x{count:<6d} {key[:90]}")


# the device kernels each counted wrapper launches, one per counted launch:
# (kernel templates as the profiler names them, "<namespace>::<name><",
# the launch_counts keys that count them); the decode merge follows its
# split kernel only when the plan has more than one split, so only the
# split kernel is held
DEVICE_KERNELS = (
    (("ragged_sm90_kernel",), ("ragged_paged_attention.sm90",
                               "ragged_paged_attention_int8.sm90")),
    (("ragged_kernel",), ("ragged_paged_attention.simt",
                          "ragged_paged_attention_int8.simt")),
    (("decode_split_kernel",), ("paged_decode_attention",
                                "paged_decode_attention_int8")),
    (("rms_norm_vec_kernel", "rms_norm_rows_kernel"), ("rms_norm",)),
    (("swiglu_vec", "swiglu_scalar"), ("swiglu",)),
    (("rope_vec_kernel", "rope_scalar_kernel"), ("fused_rope",
                                                 "fused_rope_bwd")),
    (("flash_fwd_sm90_kernel",), ("flash_attention.sm90",
                                  "flashmask_attention.sm90")),
    (("flash_fwd_kernel",), ("flash_attention.simt",
                             "flashmask_attention.simt")),
    (("bdrln_kernel",), ("bias_dropout_residual_ln",)))
TRACE_LOSS = 0.005     # share of a name's kernels the trace may drop
# host time left between the trace's start and the window's first launch,
# and between the window's last kernel and the trace's stop: the profiler
# keeps only device records whose times, moved onto the host's clock, fall
# inside [start, stop], and that move is not exact, so a kernel launched
# at once after the start (or ended just before the stop) can fall outside
TRACE_EDGE_S = 0.05


def _check_device_launches(tag, prof, counted):
    """The device kernels a profiled window ran, by DEVICE_KERNELS' names,
    against the launches the wrappers counted over the same window (with
    graphs: the counts each replay adds from its capture). The window's
    edges are padded by TRACE_EDGE_S of host time, since without that the
    trace dropped the first kernels of a window (up to a layer or two of
    them); a name may still run up to TRACE_LOSS of its counted launches
    (at least one) fewer, less than one replay's worth (32 a layer loop);
    never more. Some kernel must have run."""
    rows = [(e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    seen, bad = {}, []
    for names, keys in DEVICE_KERNELS:
        ran = sum(c for k, c in rows
                  if any(f"::{n}<" in k for n in names))
        want = sum(counted[k] for k in keys)
        seen[names[0]] = [ran, want]
        if not want - max(1, int(want * TRACE_LOSS)) <= ran <= want:
            bad.append(names[0])
    shown = json.dumps({k: v for k, v in seen.items() if any(v)})
    print(f"[{tag}] device kernels against counted launches over the "
          f"window [traced, counted]: {shown}", flush=True)
    if bad or not any(ran for ran, _ in seen.values()):
        raise AssertionError(f"[{tag}] device kernels and counted launches "
                             f"differ for {bad or 'every kernel (none ran)'}"
                             f" [traced, counted]: {shown}")


def _profile_admission(eng, prompts, n_new, tag):
    """The dense workload again on `eng` (warm: its programs are built):
    the first dense admission of the wave (the `_admit` call of its first
    engine step: c = 4, s_pad = 256, a replayed graph) under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    admit = eng._admit
    walls, counted = [], {}

    def profiled_admit(admissions):
        torch.cuda.synchronize()
        before = K.launch_counts()
        prof.start_trace()
        time.sleep(TRACE_EDGE_S)
        t0 = time.perf_counter()
        admit(admissions)                 # ends in a host sync
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        time.sleep(TRACE_EDGE_S)
        prof.stop_trace()
        after = K.launch_counts()
        counted.update({k: after[k] - before[k] for k in after})

    eng.blocks.invalidate_index()
    tokens = eng.stats["prefill_tokens"]
    eng._admit = profiled_admit
    try:
        with torch.inference_mode():
            for p in prompts:
                eng.add_request(p, max_new_tokens=n_new)
            # the profiler's warm-up, as _profile_serve's step before its
            # window: prepared just before the admission, the trace can
            # still miss its first layer's kernels, so some device work
            # is traced first
            prof.prepare_trace()
            x = torch.zeros(1 << 20, device=eng.device)
            for _ in range(256):
                x.add_(1.0)
            torch.cuda.synchronize()
            del x
            eng.step()
    finally:
        del eng._admit
    if len(walls) != 1:
        raise AssertionError("engine step 0 made no single dense admission")
    _print_profile(tag, prof, walls[0],
                   f"one dense admission (c=4, s_pad=256, "
                   f"{eng.stats['prefill_tokens'] - tokens} prompt tokens)")
    _check_device_launches(tag, prof, counted)


PROFILE_STEPS = (2, 8)   # engine steps [from, to) of the profiled window
# the host calls counted as launches in a profile: each puts work on the
# card (a kernel, a whole CUDA graph, a copy)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchKernelEx", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _profile_serve(eng, prompts, n_new, tag):
    """The same workload again on `eng` (warm: its programs are built),
    with engine steps PROFILE_STEPS under torch.profiler: device time by
    kernel, the device's busy share of the window's wall time, and host
    launch calls and device kernels per engine step. (Profiled apart so
    that the timed waves carry no tracing cost; a window rather than the
    whole run keeps the profiler's post-processing short.)"""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    eng.blocks.invalidate_index()
    marks = _trace_counts(eng)
    with torch.inference_mode():
        for p in prompts:
            eng.add_request(p, max_new_tokens=n_new)
        n = 0
        while eng.has_work():
            if n == PROFILE_STEPS[0] - 1:
                # the profiler's warm-up: tracing set up a step before
                # the window (started cold, a trace can miss the window's
                # first kernels)
                prof.prepare_trace()
            if n == PROFILE_STEPS[0]:
                torch.cuda.synchronize()
                before = dict(eng.stats)
                counts = K.launch_counts()
                prof.start_trace()
                time.sleep(TRACE_EDGE_S)
                t0 = time.perf_counter()
            eng.step()
            n += 1
            if n == PROFILE_STEPS[1]:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(TRACE_EDGE_S)
                prof.stop_trace()
                after = dict(eng.stats)
                counted = {k: v - counts[k]
                           for k, v in K.launch_counts().items()}
    if n < PROFILE_STEPS[1]:
        raise AssertionError(f"the workload took {n} engine steps, fewer "
                             f"than the profiled window {PROFILE_STEPS}")
    if _trace_counts(eng) != marks:
        raise AssertionError(f"[{tag}] the profiled wave built programs")
    window = {k: after[k] - before[k] for k in
              ("ragged_steps", "decode_chunks", "decode_tokens",
               "mixed_decode_tokens")}
    _print_profile(tag, prof, wall,
                   f"engine steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1} "
                   f"of {n} {json.dumps(window)}",
                   steps=PROFILE_STEPS[1] - PROFILE_STEPS[0])
    _check_device_launches(tag, prof, counted)


# ----------------------------------------------------------------------
# GPT and BERT: the second served model and the encoder
# ----------------------------------------------------------------------

# what the tiny GPT's agreement runs must launch on the card (decode and
# ragged attention, their int8 twins, the dense admission's flash)
GPT_AGREE_KERNELS = ("ragged_paged_attention", "paged_decode_attention",
                     "flash_attention", "ragged_paged_attention_int8",
                     "paged_decode_attention_int8")


def _tiny_gpt_pair(dev):
    """A 2-layer tiny GPT in float32 with one set of seeded weights on the
    CPU (plain versions) and on the card (kernels)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.tiny()
    cpu = GPTForCausalLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state,
                                        GPTForCausalLM(cfg, device=dev))
    return cfg, cpu, gpu


def phase_agree_gpt(dev):
    """The tiny GPT (multi-head: 4 KV heads of 16), CPU plain versions
    against the card's kernels: greedy generate waves through the prefix
    cache, chunked prefill and mixed steps, through dense admissions, and
    with spec decoding (the n-gram and the draft-model drafters), each on
    float and int8 pools. On the card each runs with CUDA graphs and as
    the eager twin. Tokens must be equal three ways, the twins' kernel
    launches equal, and the card runs must launch decode, ragged and flash
    attention and the int8 twins."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, cpu, gpu = _tiny_gpt_pair(dev)
    base = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                prefill_chunk=8, mixed_step=True)
    spec = dict(max_slots=4, page_size=4, max_seq_len=64, mixed_step=False)
    workloads = [
        ("chunked+prefix", _serving_prompts(np.random.default_rng(1), 6, 9,
                                            20, cfg.vocab_size, 12, (0, 4)),
         base, None),
        ("dense admission", _serving_prompts(np.random.default_rng(3), 6, 3,
                                             9, cfg.vocab_size, 4, (0, 4)),
         dict(base, max_slots=3), None),
        ("spec:ngram", SPEC_PROMPTS, spec, "ngram"),
        ("spec:draft_model", SPEC_PROMPTS, spec, "draft_model"),
    ]
    total = dict.fromkeys(K.launch_counts(), 0)
    bad = []
    for kv in (None, "int8"):
        for name, prompts, kw, drafter in workloads:
            tag = f"{'float' if kv is None else 'int8'} {name}"

            def engine(model, graphs):
                sd = DraftModelDrafter(model, kv_dtype=kv) \
                    if drafter == "draft_model" else (drafter or False)
                eng = GenerationEngine(model, kv_dtype=kv, spec_decode=sd,
                                       **kw)
                _set_graphs(eng, graphs)
                return eng

            want = _wave(engine(cpu, False), prompts, 12)
            runs = []
            for on in (True, False):
                eng = engine(gpu, on)
                K.reset_launch_counts()
                toks = _wave(eng, prompts, 12)
                runs.append((toks, K.launch_counts(), dict(eng.stats)))
            (g_tok, g_l, st), (e_tok, e_l, _) = runs
            same = all(np.array_equal(a, b) for a, b in zip(want, g_tok))
            twin = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
            drafted = st["spec_draft_tokens"]
            print(f"[agree:gpt] {tag}: cpu == cuda graphs {same}; graphs "
                  f"== eager {twin}; launches equal {g_l == e_l}; "
                  f"prefill_admits={st['prefill_admits']} ragged_steps="
                  f"{st['ragged_steps']} prefix_hits={st['prefix_hits']} "
                  f"spec drafted/accepted={drafted}/"
                  f"{st['spec_accepted_tokens']}; launches "
                  f"{json.dumps({k: g_l[k] for k in GPT_AGREE_KERNELS})}",
                  flush=True)
            if not (same and twin and g_l == e_l) or \
                    (drafter and drafted < 1):
                bad.append(tag)
            for k in total:
                total[k] += g_l[k]
    if bad:
        raise AssertionError(f"[agree:gpt] disagreements (or no draft) in "
                             f"{bad}")
    _require_launched("agree:gpt", total, GPT_AGREE_KERNELS)


def _serving_gpt(dev):
    """GPT-3 1.3B (GPTConfig.gpt3_1p3b(): hidden 2048, 16 heads of 128,
    FFN 8192, vocab 50304, 2048 positions), all 24 layers, bfloat16,
    random weights from seed 0."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve:gpt] gpt3_1p3b, layers={cfg.num_hidden_layers}, "
          f"params={n_params / 1e9:.3f}B bf16, init_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    return model


def _agree_module(dev, tag, make, call, expect=None):
    """One module made by make(device) on the CPU and on the card with the
    same numpy-seeded parameters (N(0, 0.3): norms and biases too, so none
    is a no-op), called by call(module, device) -> tensor or tuple; every
    output's largest error must be within 1e-4 of its largest value.
    expect: {kernel: launches} the card's call must make. Returns the
    card's launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.ops import kernels as K

    cpu = make("cpu").eval()
    rng = np.random.default_rng(0)
    state = {n: (0.3 * rng.standard_normal(tuple(p.shape))).astype(
        np.float32) for n, p in cpu.named_parameters()}
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state, make(dev)).eval()
    with torch.no_grad():
        want = call(cpu, "cpu")
        K.reset_launch_counts()
        got = call(gpu, dev)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    errs = [(_max_err(g.cpu(), w), float(w.float().abs().max()))
            for g, w in zip(got, want)]
    ok = len(got) == len(want) and all(e <= 1e-4 * m for e, m in errs)
    counted = {k: launches[k] for k in (expect or {})}
    print(f"[agree:bert] {tag}: max_abs_err/max|want| " + " ".join(
        f"{e:.2e}/{m:.2e}" for e, m in errs) + f" (<= 1e-4); launches "
        f"{json.dumps(counted)}", flush=True)
    if not ok:
        raise AssertionError(f"[agree:bert] {tag}: CPU plain path and CUDA "
                             f"kernel path disagree")
    if expect and counted != expect:
        raise AssertionError(f"[agree:bert] {tag}: launches {counted}, "
                             f"expected {expect}")
    return launches


def phase_agree_bert(dev):
    """The tiny BERT's three heads (with and without an attention mask, the
    masked-LM and classification losses), the transformer layers
    (MultiHeadAttention step by step through a Cache and over a
    StaticCache, a Transformer with a causal target mask) and the fused
    layers and functionals (the six incubate layers, fused_multi_transformer,
    block_multihead_attention), float32, CPU plain versions against the
    card's kernels. Attention without a mask must launch the flash kernel
    once a layer, with a mask never; the post-norm fused layers launch
    bdrln, block_multihead_attention the decode kernel."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.incubate import nn as tinn
    from paddle_tpu_torch.incubate.nn import functional as TIF
    from paddle_tpu_torch.models import bert as tbert

    cfg = tbert.BertConfig.tiny()
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(7)
    ids = rng.integers(1, cfg.vocab_size, (3, 16))
    types = rng.integers(0, 2, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    mlm_labels = rng.integers(0, cfg.vocab_size, (3, 16))
    mlm_labels[:, ::3] = -100
    cls_labels = rng.integers(0, 2, 3)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)

    def t(a, d):
        return torch.from_numpy(np.asarray(a)).to(d)

    total = {}

    def agree(tag, make, call, expect=None):
        for k, v in _agree_module(dev, tag, make, call, expect).items():
            total[k] = total.get(k, 0) + v

    for masked in (False, True):
        m = mask if masked else None
        flash = {"flash_attention": 0 if masked else layers}
        sfx = "masked" if masked else "unmasked"
        agree(f"BertModel {sfx}",
              lambda d: tbert.BertModel(cfg, device=d),
              lambda mod, d: mod(t(ids, d), t(types, d),
                                 None if m is None else t(m, d)), flash)
        agree(f"BertForMaskedLM {sfx} logits+loss",
              lambda d: tbert.BertForMaskedLM(cfg, device=d),
              lambda mod, d: (mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d)),
                              mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d),
                                  t(mlm_labels, d))))
        agree(f"BertForSequenceClassification {sfx} logits+loss",
              lambda d: tbert.BertForSequenceClassification(cfg, device=d),
              lambda mod, d: (mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d)),
                              mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d),
                                  t(cls_labels, d))))

    def mha_caches(mod, d):
        xd = t(x, d)
        cache, outs = mod.gen_cache(xd), []
        for lo, hi in ((0, 2), (2, 3), (3, 6)):
            out, cache = mod(xd[:, lo:hi], cache=cache)
            outs.append(out)
        static = mod.gen_cache(xd, xd, tnn.MultiHeadAttention.StaticCache)
        return outs + [cache.k, cache.v, mod(xd, cache=static)]
    agree("MultiHeadAttention Cache x3 + StaticCache",
          lambda d: tnn.MultiHeadAttention(64, 4, device=d), mha_caches,
          {"flash_attention": 4})

    def transformer(mod, d):
        return mod(t(x, d), t(x[:, :5], d), None,
                   mod.generate_square_subsequent_mask(5))
    # encoder self-attention and decoder cross-attention unmasked (flash),
    # decoder self-attention under the causal mask (dense)
    agree("Transformer (causal target mask)",
          lambda d: tnn.Transformer(64, 4, 2, 2, 128, dropout=0.0,
                                    device=d), transformer,
          {"flash_attention": 4})

    keep = np.ones((2, 1, 6, 6), bool)
    keep[0, :, :, 4:] = False
    agree("FusedLinear", lambda d: tinn.FusedLinear(64, 32, device=d),
          lambda mod, d: mod(t(x, d)))
    agree("FusedDropoutAdd (eval)", lambda d: tinn.FusedDropoutAdd(0.5),
          lambda mod, d: mod(t(x, d), t(x[::-1].copy(), d)))
    agree("FusedMultiHeadAttention post-norm, unmasked and masked",
          lambda d: tinn.FusedMultiHeadAttention(64, 4, device=d),
          lambda mod, d: (mod(t(x, d)), mod(t(x, d), attn_mask=t(keep, d))),
          {"flash_attention": 1, "bias_dropout_residual_ln": 2})
    agree("FusedFeedForward post-norm gelu",
          lambda d: tinn.FusedFeedForward(64, 128, activation="gelu",
                                          device=d),
          lambda mod, d: mod(t(x, d)), {"bias_dropout_residual_ln": 1})
    agree("FusedTransformerEncoderLayer post-norm",
          lambda d: tinn.FusedTransformerEncoderLayer(64, 4, 128, device=d),
          lambda mod, d: mod(t(x, d)),
          {"flash_attention": 1, "bias_dropout_residual_ln": 2})
    agree("FusedMultiTransformer pre-norm x2",
          lambda d: tinn.FusedMultiTransformer(64, 4, 128, num_layers=2,
                                               device=d),
          lambda mod, d: mod(t(x, d)), {"flash_attention": 2})

    class Stack(torch.nn.Module):
        """fused_multi_transformer's per-layer weight lists as
        parameters."""

        def __init__(self, d):
            super().__init__()
            shapes = {"ln_scales": [64], "ln_biases": [64],
                      "qkv_weights": [3, 4, 16, 64],
                      "qkv_biases": [3, 4, 16], "linear_weights": [64, 64],
                      "linear_biases": [64], "ffn_ln_scales": [64],
                      "ffn_ln_biases": [64], "ffn1_weights": [64, 128],
                      "ffn1_biases": [128], "ffn2_weights": [128, 64],
                      "ffn2_biases": [64]}
            self.names = list(shapes)
            for n, s in shapes.items():
                setattr(self, n, torch.nn.ParameterList(
                    [torch.nn.Parameter(torch.empty(s, device=d))
                     for _ in range(2)]))

        def forward(self, xd):
            return TIF.fused_multi_transformer(
                xd, *[list(getattr(self, n)) for n in self.names])
    agree("fused_multi_transformer", Stack, lambda mod, d: mod(t(x, d)),
          {"flash_attention": 2})

    class Paged(torch.nn.Module):
        """block_multihead_attention over a page pool (GQA 4 -> 2)."""

        def __init__(self, d):
            super().__init__()
            self.q = torch.nn.Parameter(torch.empty(2, 4, 16, device=d))
            self.kp = torch.nn.Parameter(torch.empty(8, 4, 2, 16, device=d))
            self.vp = torch.nn.Parameter(torch.empty(8, 4, 2, 16, device=d))

        def forward(self, d):
            bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=d)
            ctx = torch.tensor([7, 5], dtype=torch.int32, device=d)
            return TIF.block_multihead_attention(self.q, self.kp, self.vp,
                                                 bt, ctx)
    agree("block_multihead_attention", Paged, lambda mod, d: mod(d),
          {"paged_decode_attention": 1})
    _require_launched("agree:bert", total, ("flash_attention",
                                            "bias_dropout_residual_ln",
                                            "paged_decode_attention"))


BERT_BATCH = (8, 512)
BERT_CALLS = 5


def _profile_forward(tag, fn):
    """One more call of fn (warm) under torch.profiler: device time by
    kernel, the idle share of its wall, and the device kernels against the
    launches the wrappers counted (as the serving windows are held)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    torch.cuda.synchronize()
    before = K.launch_counts()
    prof.start_trace()
    time.sleep(TRACE_EDGE_S)
    t0 = time.perf_counter()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    time.sleep(TRACE_EDGE_S)
    prof.stop_trace()
    after = K.launch_counts()
    _print_profile(tag, prof, wall, "one forward")
    _check_device_launches(tag, prof, {k: after[k] - before[k]
                                       for k in after})


def _time_calls(fn, n=BERT_CALLS):
    """(ms per call by CUDA events over n calls after one warm-up, the
    kernel launches the n calls counted, the last output)."""
    from paddle_tpu_torch.ops import kernels as K

    fn()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, K.launch_counts(), out


def phase_bert(K, dev):
    """BERT-base (BertConfig.bert_base(): 12 layers, hidden 768, 12 heads
    of 64, FFN 3072, vocab 30522) in bfloat16, eval, random weights from
    seed 0: BertForMaskedLM over 8 x 512 tokens unmasked (the flash kernel,
    non-causal, D = 64: 12 launches a forward on the tensor-core route)
    and with a padding mask (the dense path: no flash launch); the two
    must agree on the unpadded row 0 (within 0.1 of the largest logit: 12
    post-LN layers of bf16 attention computed two ways); one more unmasked
    forward runs under torch.profiler. Then
    FusedMultiTransformer at the same widths, 12 layers (pre-norm). Prints
    ms per forward. Returns the timed calls' kernel launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.incubate import nn as tinn
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM

    _release()
    cfg = BertConfig.bert_base()
    b, s = BERT_BATCH
    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16).eval()
    weights.init_random_(model, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                        device=dev)
    lens = torch.tensor([s - 48 * i for i in range(b)], device=dev)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).long()
    total = dict.fromkeys(K.launch_counts(), 0)
    outs = {}
    for tag, m in (("unmasked", None), ("masked", mask)):
        with torch.inference_mode():
            ms, launches, out = _time_calls(lambda: model(ids,
                                                          attention_mask=m))
        want = 0 if m is not None else cfg.num_hidden_layers * BERT_CALLS
        flash = (launches["flash_attention"],
                 launches["flash_attention.sm90"])
        print(f"[bert] BertForMaskedLM {b}x{s} bf16 {tag}: "
              f"ms_per_forward={ms:.3f} flash launches (all, sm90) {flash} "
              f"over {BERT_CALLS} forwards; peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        if flash != (want, want):
            raise AssertionError(f"[bert] {tag}: flash launches {flash}, "
                                 f"expected {want} on the tensor-core route")
        if tuple(out.shape) != (b, s, cfg.vocab_size) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[bert] {tag}: logits not finite "
                                 f"[{b}, {s}, {cfg.vocab_size}]")
        outs[tag] = out[0].float()
        for k in total:
            total[k] += launches[k]
        if m is None:
            _profile_forward(f"profile:bert:{tag}",
                             lambda: model(ids, attention_mask=m))
    diff = float((outs["unmasked"] - outs["masked"]).abs().max())
    top = float(outs["unmasked"].abs().max())
    print(f"[bert] row 0 (no padding): flash vs dense path max_abs_diff="
          f"{diff:.4f} max|logit|={top:.4f} (<= 0.1 of it)", flush=True)
    if diff > 0.1 * top:
        raise AssertionError("[bert] the flash and dense paths disagree on "
                             "the unpadded row")
    del model, outs, out
    _release()
    fmt = tinn.FusedMultiTransformer(
        cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
        num_layers=cfg.num_hidden_layers, device=dev,
        dtype=torch.bfloat16).eval()
    weights.init_random_(fmt, seed=0)
    x = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        ms, launches, out = _time_calls(lambda: fmt(x))
    want = cfg.num_hidden_layers * BERT_CALLS
    flash = (launches["flash_attention"], launches["flash_attention.sm90"])
    print(f"[bert] FusedMultiTransformer 12 layers {b}x{s}x"
          f"{cfg.hidden_size} bf16: ms_per_forward={ms:.3f} flash launches "
          f"(all, sm90) {flash}; peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    if flash != (want, want) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[bert] FusedMultiTransformer: flash launches "
                             f"{flash} (expected {want}) or output not "
                             f"finite")
    for k in total:
        total[k] += launches[k]
    del fmt, out, x
    _release()
    return total


# [agree:train2]: the rest of training on tiny float32 problems, the CPU's
# plain path against the card
TRAIN2_SHAPES = ((64, 48), (48,), (33, 17))
TRAIN2_OPTIMIZERS = {
    "SGD": lambda o, ps: o.SGD(0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda o, ps: o.Momentum(0.05, 0.9, parameters=ps,
                                         use_nesterov=True),
    "Adam(lazy_mode)": lambda o, ps: o.Adam(0.01, parameters=ps,
                                            lazy_mode=True),
    "Adamax": lambda o, ps: o.Adamax(0.02, parameters=ps),
    "Adagrad": lambda o, ps: o.Adagrad(0.1, parameters=ps,
                                       initial_accumulator_value=0.1),
    "Adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda o, ps: o.RMSProp(0.01, rho=0.9, momentum=0.5,
                                       centered=True, parameters=ps),
    "Lamb": lambda o, ps: o.Lamb(0.01, parameters=ps),
    "NAdam": lambda o, ps: o.NAdam(0.01, parameters=ps),
    "RAdam": lambda o, ps: o.RAdam(0.01, beta2=0.9, parameters=ps),
    "ASGD": lambda o, ps: o.ASGD(0.05, parameters=ps),
    "Rprop": lambda o, ps: o.Rprop(0.01, parameters=ps),
}


def _warmup_cosine(lr_mod, peak, warmup, t_max, start=0.0):
    """LinearWarmup(CosineAnnealingDecay(peak, t_max), warmup, start,
    peak): the schedule the GPT phases train under."""
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(peak, t_max),
                               warmup, start, peak)


def _remat_per_step(layers):
    """Launches of each kernel in one Llama training step with
    apply_llama_remat over `layers` layers: every forward kernel of a
    layer runs twice (the forward and its replay in the backward), the
    final norm once, the backward kernels once."""
    return {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rms_norm": 4 * layers + 1, "swiglu": 2 * layers,
            "fused_rope": 2 * layers, "fused_rope.qk": 2 * layers,
            "fused_rope_bwd": layers}


def _agree_optimizers(dev):
    """3 steps of each optimizer on the same parameters and gradients on
    both devices; (worst max|err| / max(1, max|want|) over parameters and
    state, LBFGS's iterate error)."""
    from paddle_tpu_torch import optimizer as O

    worst = {}
    for name, make in TRAIN2_OPTIMIZERS.items():
        rng = np.random.default_rng(len(name))
        start = [rng.standard_normal(s).astype(np.float32)
                 for s in TRAIN2_SHAPES]
        grads = [[rng.standard_normal(s).astype(np.float32)
                  for s in TRAIN2_SHAPES] for _ in range(3)]
        runs = {}
        for d in ("cpu", dev):
            # torch.tensor copies: a CPU parameter made by from_numpy
            # would write its steps into `start`
            ps = [torch.nn.Parameter(torch.tensor(a, device=d))
                  for a in start]
            opt = make(O, ps)
            for gs in grads:
                for p, g in zip(ps, gs):
                    p.grad = torch.tensor(g, device=d)
                opt.step()
                opt.clear_grad()
            runs[str(d)] = [p.detach().cpu() for p in ps] + [
                v.cpu() for k, v in opt.state_dict().items()
                if k != "@step"]
        worst[name] = max(
            float((b - a).abs().max()) / max(1.0, float(a.abs().max()))
            for a, b in zip(runs["cpu"], runs[str(dev)]))
    rng = np.random.default_rng(4)
    m = rng.standard_normal((6, 6)).astype(np.float32)
    a = m @ m.T / 6 + np.eye(6, dtype=np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    xs = {}
    for d in ("cpu", dev):
        x = torch.nn.Parameter(torch.zeros(6, device=d))
        ta, tb = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
        opt = O.LBFGS(1.0, max_iter=4, history_size=5, parameters=[x])

        def closure(x=x, ta=ta, tb=tb, opt=opt):
            opt.clear_grad()
            loss = 0.5 * (x * (ta @ x)).sum() - (tb * x).sum()
            loss.backward()
            return loss

        opt.step(closure)
        xs[str(d)] = x.detach().cpu()
    worst["LBFGS"] = float((xs["cpu"] - xs[str(dev)]).abs().max())
    return worst


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def phase_agree_train2(dev):
    """The rest of training on tiny float32 problems, CPU plain versions
    against the card: each new optimizer over 3 steps (parameters and
    state within 1e-5 of max(1, max|value|): the same float32 elementwise
    operations, one rounding apart where CUDA fuses a multiply-add) and
    LBFGS on a quadratic (iterates within 1e-4); AdamW under
    LinearWarmup(CosineAnnealingDecay) driving the tiny Llama (losses
    within 1e-4, rates equal); on the card the tiny Llama with
    apply_llama_remat against itself without remat (losses within 1e-6,
    first gradients within 1e-5 of the largest, the launches of
    _remat_per_step); the tiny GPT, 3 AdamW steps (losses 1e-4); a tiny
    BERT (hidden 128, 2 heads of 64: the tensor-core flash route in bf16)
    under decorate(O2) + GradScaler(1024), dropout 0, 4 steps (first loss
    within 2 bf16 ulps, then within 5% or 0.0625: AdamW's first steps are
    ~lr sign(g), and the two devices' bf16 roundings decide the sign of
    some near-zero gradients apart); a checkpoint of the card's model and
    AdamW state loaded on the CPU bit for bit."""
    tag = "agree:train2"
    worst = _agree_optimizers(dev)
    print(f"[{tag}] optimizers, 3 steps, max|err| / max(1, max|want|) "
          f"(<= 1e-5; LBFGS iterate <= 1e-4): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}",
          flush=True)
    bad = [k for k, v in worst.items()
           if v > (1e-4 if k == "LBFGS" else 1e-5)]
    if bad:
        raise AssertionError(f"[{tag}] optimizers disagree: {bad}")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    lab = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    batch = {"cpu": (ids, lab), "gpu": (ids.to(dev), lab.to(dev))}
    _agree_schedule(tag, dev, batch)
    _agree_remat(tag, dev, batch)
    _agree_gpt_steps(tag, dev, batch)
    blab = ids.clone()
    blab[torch.from_numpy(rng.random(tuple(ids.shape)) >= 0.3)] = -100
    _agree_bert_o2(tag, dev, {"cpu": (ids, blab),
                              "gpu": (ids.to(dev), blab.to(dev))})
    _agree_checkpoint(tag, dev)


def _agree_schedule(tag, dev, batch):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import compile_train_step

    _, cpu, gpu = _tiny_pair(dev)
    losses, rates = {}, {}
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        sched = _warmup_cosine(O.lr, 1e-3, 2, 10)
        opt = O.AdamW(sched, parameters=model.parameters())
        step = compile_train_step(model, lambda m, i, l: m(i, labels=l),
                                  opt)
        losses[key], rates[key] = [], []
        for _ in range(3):
            rates[key].append(opt.get_lr())
            losses[key].append(float(step(*batch[key])))
            sched.step()
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny Llama, AdamW under LinearWarmup(Cosine): rates "
          f"{rates['gpu']} losses cpu {losses['cpu']} cuda {losses['gpu']}"
          f" max_err={err:.3e} (<= 1e-4)", flush=True)
    if err > 1e-4 or rates["cpu"] != rates["gpu"]:
        raise AssertionError(f"[{tag}] the scheduled AdamW runs disagree")


def _agree_remat(tag, dev, batch):
    import copy

    from paddle_tpu_torch.models import apply_llama_remat
    from paddle_tpu_torch.ops import kernels as K

    _, _, plain = _tiny_pair(dev)
    remat = apply_llama_remat(copy.deepcopy(plain))
    got = {}
    for key, model in (("plain", plain), ("remat", remat)):
        model.train()
        K.reset_launch_counts()
        loss = model(batch["gpu"][0], labels=batch["gpu"][1])
        loss.backward()
        got[key] = (float(loss.detach()), K.launch_counts(),
                    [p.grad.detach().clone() for p in model.parameters()])
    top = max(float(g.abs().max()) for g in got["plain"][2])
    gerr = max(float((a - b).abs().max())
               for a, b in zip(got["plain"][2], got["remat"][2]))
    want = _remat_per_step(len(remat.llama.layers))
    counts = {k: got["remat"][1][k] for k in want}
    print(f"[{tag}] tiny Llama on the card, apply_llama_remat against "
          f"none: loss {got['remat'][0]} vs {got['plain'][0]}, first-step "
          f"grads max_err={gerr:.3e} (<= 1e-5 x {top:.3e}); remat launches "
          f"{json.dumps(counts)}", flush=True)
    if abs(got["remat"][0] - got["plain"][0]) > 1e-6 or gerr > 1e-5 * top:
        raise AssertionError(f"[{tag}] remat changed the numbers")
    if counts != want:
        raise AssertionError(f"[{tag}] remat launched {counts}, expected "
                             f"{want}")


def _agree_gpt_steps(tag, dev, batch):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import compile_train_step

    _, gcpu, ggpu = _tiny_gpt_pair(dev)
    losses = {}
    for key, model in (("cpu", gcpu), ("gpu", ggpu)):
        model.train()
        step = compile_train_step(model, lambda m, i, l: m(i, labels=l),
                                  O.AdamW(1e-3,
                                          parameters=model.parameters()))
        losses[key] = [float(step(*batch[key])) for _ in range(3)]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny GPT, 3 AdamW steps: losses cpu {losses['cpu']} "
          f"cuda {losses['gpu']} max_err={err:.3e} (<= 1e-4)", flush=True)
    if err > 1e-4 or not losses["gpu"][-1] < losses["gpu"][0]:
        raise AssertionError(f"[{tag}] tiny GPT training disagrees")


def _agree_bert_o2(tag, dev, batch):
    from paddle_tpu_torch import amp, weights
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.ops import kernels as K

    cfg = BertConfig.tiny(hidden=128, heads=2, ffn=256)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cpu = BertForMaskedLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state, BertForMaskedLM(cfg,
                                                               device=dev))
    losses, scales = {}, {}
    K.reset_launch_counts()
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        opt = O.AdamW(3e-3, parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        losses[key] = []
        for _ in range(4):
            with amp.auto_cast(level="O2"):
                loss = model(batch[key][0], labels=batch[key][1])
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses[key].append(float(loss.detach()))
        scales[key] = scaler._scale
    n = K.launch_counts()
    first = abs(losses["cpu"][0] - losses["gpu"][0])
    ok = first <= 2 * _bf16_ulp(losses["cpu"][0]) and all(
        abs(a - b) <= max(0.0625, 0.05 * abs(a))
        for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny BERT (h 128, 2 heads of 64) decorate(O2) + "
          f"GradScaler(1024): losses cpu {losses['cpu']} cuda "
          f"{losses['gpu']} scale {scales}; flash launches (all, sm90) "
          f"{(n['flash_attention'], n['flash_attention.sm90'])}, backward "
          f"sm90 {n['flash_attention_bwd.sm90']}", flush=True)
    if not ok or scales["cpu"] != scales["gpu"]:
        raise AssertionError(f"[{tag}] the O2 BERT runs disagree")
    want = 4 * cfg.num_hidden_layers
    if n["flash_attention.sm90"] != want or \
            n["flash_attention_bwd.sm90"] != want:
        raise AssertionError(f"[{tag}] the O2 BERT did not take the "
                             f"tensor-core flash route every layer")


def _agree_checkpoint(tag, dev):
    import tempfile

    from paddle_tpu_torch.distributed import checkpoint as ckpt

    _, _, gpu = _tiny_pair(dev)
    sd = {**gpu.state_dict(), **_opt_state_of(gpu)}
    sd["wte_bf16"] = gpu.llama.embed_tokens.weight.detach().bfloat16()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_state_dict(sd, d)
        back = {k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in sd.items() if isinstance(v, torch.Tensor)}
        missing = ckpt.load_state_dict(back, d)
    same = all(torch.equal(back[k].reshape(-1).view(torch.uint8),
                           sd[k].detach().cpu().reshape(-1).view(
                               torch.uint8)) for k in back)
    print(f"[{tag}] checkpoint of the card's tiny Llama + AdamW state "
          f"({len(back)} tensors, bf16 among them) loaded on the CPU: "
          f"bit-equal={same}, missing={missing}", flush=True)
    if not same or missing:
        raise AssertionError(f"[{tag}] the checkpoint did not round-trip "
                             f"bit for bit")


def _opt_state_of(model):
    """The AdamW state of one more step of `model` (its live tensors, as
    a checkpoint saves them)."""
    from paddle_tpu_torch import optimizer as O

    opt = O.AdamW(1e-3, parameters=model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    opt.clear_grad()
    return opt.state_dict()


# [train:remat]: bench.py:147-170 exactly: TRAIN_CFG with recompute=True
# and apply_llama_remat
TRAIN_REMAT_PER_STEP = {**_remat_per_step(TRAIN_CFG["num_hidden_layers"]),
                        "flash_attention.sm90": 24,
                        "flash_attention_bwd.sm90": 12,
                        "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}


def _remat_flops(cfg, n_matmul):
    """Flops the card does on top of the model's in a remat step: each
    decoder layer's forward again (2 T per matmul parameter of the layers,
    lm_head excluded, and attention's 2 forward causal products)."""
    t = TRAIN_BATCH * TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    layer_params = n_matmul - cfg.hidden_size * cfg.vocab_size
    return 2 * layer_params * t + 4 * TRAIN_BATCH * \
        cfg.num_attention_heads * hd * _causal_pairs(TRAIN_SEQ, TRAIN_SEQ) * \
        cfg.num_hidden_layers


def _profile_step(tag, step, batch):
    """One more training step under torch.profiler, its device kernels
    held against the launches the wrappers counted (as the serving
    windows are held)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    # device work traced before the window, as _profile_admission does:
    # prepared just before the step, the trace missed its first layer's
    # kernels (3 RMSNorms, a RoPE, a flash and a SwiGLU launch)
    x = torch.zeros(1 << 20, device=batch[0].device)
    for _ in range(256):
        x.add_(1.0)
    torch.cuda.synchronize()
    del x
    before = K.launch_counts()
    prof.start_trace()
    time.sleep(TRACE_EDGE_S)
    t0 = time.perf_counter()
    float(step(*batch))
    wall = time.perf_counter() - t0
    time.sleep(TRACE_EDGE_S)
    prof.stop_trace()
    after = K.launch_counts()
    _print_profile(tag, prof, wall, "one training step")
    _check_device_launches(tag, prof, {k: after[k] - before[k]
                                       for k in after})


def phase_train_remat(K, dev, base):
    """bench.py:147-170: TRAIN_CFG with recompute=True and
    apply_llama_remat, bf16, AdamW(1e-4, multi_precision=True), the same
    weights (seed 0) and batch (seed 1) as [train]; a warm-up and
    TRAIN_STEPS timed steps, each launching TRAIN_REMAT_PER_STEP; every
    loss within 2 bf16 ulps of [train]'s (remat replays the same kernels
    on the same inputs: it must not change the numbers); peak memory
    below [train]'s; then one step profiled, its device kernels held to
    the counted launches. Returns the timed steps' launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_remat)

    tag = "train:remat"
    _release()
    cfg = LlamaConfig(**TRAIN_CFG, recompute=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    apply_llama_remat(model)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    step, _ = _train_step(model, 1e-4, multi_precision=True)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    losses, ms, totals = _run_steps(tag, K, step, batch,
                                    TRAIN_REMAT_PER_STEP, TRAIN_STEPS)
    step_ms = sum(ms[1:]) / len(ms[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, formula = _train_flops(cfg, n_matmul)
    hw = flops + _remat_flops(cfg, n_matmul)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    diffs = [abs(a - b) for a, b in zip(losses, base["losses"])]
    print(f"[{tag}] bench.py:147-170: TRAIN_CFG with recompute=True + "
          f"apply_llama_remat, bf16, AdamW(1e-4, multi_precision=True), "
          f"batch {TRAIN_BATCH}x{TRAIN_SEQ}")
    print(f"[{tag}] losses (warm-up first) {losses}; [train]'s "
          f"{base['losses']}; max |diff| {max(diffs):.4g} (<= 2 bf16 ulps)")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} (train {base['step_ms']:.2f}) tokens_per_s="
          f"{tokens / step_ms * 1e3:.1f} peak_mem_gb={peak:.2f} (train "
          f"{base['peak_gb']:.2f})")
    print(f"[{tag}] model flops/step {formula}; MFU={flops / (step_ms / 1e3) / 989e12:.4f}"
          f" (model flops, the replayed forward not counted); hardware "
          f"flops/step {hw:.4e} = model + the replayed layers' forward "
          f"{hw - flops:.4e}; hardware flops rate "
          f"{hw / (step_ms / 1e3) / 989e12:.4f} of 989 TFLOP/s")
    print(f"[{tag}] launches per step {json.dumps(TRAIN_REMAT_PER_STEP)} "
          f"(held every step)", flush=True)
    if any(d > 2 * _bf16_ulp(a) for d, a in zip(diffs, base["losses"])):
        raise AssertionError(f"[{tag}] remat changed the losses")
    if not peak < base["peak_gb"]:
        raise AssertionError(f"[{tag}] peak memory {peak:.2f} GB is not "
                             f"below [train]'s {base['peak_gb']:.2f}")
    _profile_step(f"profile:{tag}", step, batch)
    del model, step
    _release()
    return totals


GPT_TRAIN_BATCH, GPT_TRAIN_SEQ, GPT_TRAIN_STEPS = 4, 2048, 3
GPT_TRAIN_PER_STEP = {"flash_attention": 24, "flash_attention_bwd": 24,
                      "flash_attention.sm90": 24,
                      "flash_attention_bwd.sm90": 24, "rms_norm": 0,
                      "swiglu": 0, "fused_rope": 0, "fused_rope_bwd": 0}


def phase_train_gpt(K, dev):
    """GPT-3 1.3B (GPTConfig.gpt3_1p3b(): all 24 layers, hidden 2048, 16
    heads of 128, FFN 8192, vocab 50304) in bf16 with random weights from
    seed 0, AdamW(multi_precision=True) under LinearWarmup(
    CosineAnnealingDecay(1e-4, 100), 1, 1e-5, 1e-4), batch 4 x 2048 from
    seed 1: a warm-up and GPT_TRAIN_STEPS timed steps of
    compile_train_step, the scheduler stepped after each; each step
    launches the flash forward and backward once a layer (tensor-core
    route) and no Llama kernel; the rate each step equals the
    scheduler's; the loss falls. Returns the timed steps' launches."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    tag = "train:gpt"
    _release()
    cfg = GPTConfig.gpt3_1p3b()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.gpt.wpe.weight.numel() - sum(
        p.numel() for n, p in model.named_parameters()
        if "ln_" in n or n.endswith("bias"))
    sched = _warmup_cosine(O.lr, 1e-4, 1, 100, start=1e-5)
    opt = O.AdamW(sched, parameters=model.parameters(), multi_precision=True)
    step = compile_train_step(model, lambda m, i, l: m(i, labels=l), opt)
    batch = _train_batch(cfg.vocab_size, GPT_TRAIN_BATCH, GPT_TRAIN_SEQ, dev)
    rates = []

    def on_step(i):
        sched.step()
        rates.append((opt.get_lr(), sched()))

    rates.append((opt.get_lr(), sched()))       # the warm-up step's rate
    losses, ms, totals = _run_steps(tag, K, step, batch, GPT_TRAIN_PER_STEP,
                                    GPT_TRAIN_STEPS, on_step)
    step_ms = sum(ms[1:]) / len(ms[1:])
    t = GPT_TRAIN_BATCH * GPT_TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    pairs = _causal_pairs(GPT_TRAIN_SEQ, GPT_TRAIN_SEQ)
    attn = 14 * GPT_TRAIN_BATCH * cfg.num_attention_heads * hd * pairs * \
        cfg.num_hidden_layers
    flops = 6 * n_matmul * t + attn
    print(f"[{tag}] GPTConfig.gpt3_1p3b(): {cfg.num_hidden_layers} layers, "
          f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, FFN "
          f"{cfg.intermediate_size}, vocab {cfg.vocab_size}; params="
          f"{n_params} bf16 (matmul N={n_matmul}, the tied head counted "
          f"once); batch {GPT_TRAIN_BATCH}x{GPT_TRAIN_SEQ}; AdamW("
          f"multi_precision=True) under LinearWarmup(CosineAnnealingDecay("
          f"1e-4, 100), 1, 1e-5, 1e-4)")
    print(f"[{tag}] losses (warm-up first) {losses}; rates (optimizer, "
          f"scheduler) of each step and after the last {rates}")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={t / step_ms * 1e3:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(f"[{tag}] flops/step 6*N*T + 14*B*H*D*pairs*L = 6*{n_matmul}*{t} "
          f"+ 14*{GPT_TRAIN_BATCH}*{cfg.num_attention_heads}*{hd}*{pairs}*"
          f"{cfg.num_hidden_layers} = {flops:.4e}; MFU="
          f"{flops / (step_ms / 1e3) / 989e12:.4f} (of 989 TFLOP/s bf16 "
          f"dense)")
    print(f"[{tag}] launches per step {json.dumps(GPT_TRAIN_PER_STEP)} "
          f"(held every step)", flush=True)
    if any(a != b for a, b in rates):
        raise AssertionError(f"[{tag}] the optimizer's rate is not the "
                             f"scheduler's: {rates}")
    del model, opt, step
    _release()
    return totals


BERT_TRAIN_BATCH, BERT_TRAIN_STEPS, BERT_MASKED = (32, 512), 5, 0.15


def phase_train_bert(K, dev):
    """BERT-base MLM (BASELINE config 2): BertForMaskedLM(bert_base()),
    random weights from seed 0, training mode with the configured dropout
    0.1, decorate(O2, bfloat16) + GradScaler(init_loss_scaling=1024),
    AdamW(1e-4), batch 32 x 512 from seed 1 with 15% of the positions
    labelled: a warm-up and BERT_TRAIN_STEPS timed steps (host clock to a
    sync), the scale after each. With dropout while training, attention
    is the dense plain path, as in the JAX package: no flash launch. The
    loss must fall; the parameters bf16 but LayerNorm's float32, with
    float32 masters. Returns the timed steps' launches."""
    from paddle_tpu_torch import amp, weights
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM

    tag = "train:bert"
    _release()
    cfg = BertConfig.bert_base()
    b, s = BERT_TRAIN_BATCH
    model = BertForMaskedLM(cfg, device=dev)
    weights.init_random_(model, seed=0)
    model.train()
    opt = O.AdamW(1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    lab = ids.copy()
    lab[rng.random((b, s)) >= BERT_MASKED] = -100
    ids, lab = torch.from_numpy(ids).to(dev), torch.from_numpy(lab).to(dev)
    scales = []

    def step(i, l):
        with amp.auto_cast(level="O2"):
            loss = model(i, labels=l)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler._scale)
        return loss.detach()

    per_step = {"flash_attention": 0, "flash_attention_bwd": 0}
    losses, ms, totals = _run_steps(tag, K, step, (ids, lab), per_step,
                                    BERT_TRAIN_STEPS)
    step_ms = sum(ms[1:]) / len(ms[1:])
    emb = model.bert.embeddings
    print(f"[{tag}] BertConfig.bert_base() BertForMaskedLM, dropout "
          f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
          f"decorate(O2, bf16) + GradScaler(1024), AdamW(1e-4), batch "
          f"{b}x{s}, {int(BERT_MASKED * 100)}% labelled")
    print(f"[{tag}] losses (warm-up first) {losses}; scale after each "
          f"step {scales}; skipped {scaler.skipped_steps}")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={b * s / step_ms * 1e3:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
          f"flash launches 0 a step (the dense path under dropout)",
          flush=True)
    if emb.word_embeddings.weight.dtype != torch.bfloat16 or \
            emb.layer_norm.weight.dtype != torch.float32 or \
            id(emb.word_embeddings.weight) not in opt._master_weights:
        raise AssertionError(f"[{tag}] O2 did not leave bf16 parameters, "
                             f"float32 LayerNorm and float32 masters")
    del model, opt
    _release()
    return totals


if __name__ == "__main__":
    sys.exit(main())
