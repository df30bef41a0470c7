"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from paddle_tpu_torch/csrc (one nvcc per
source, all started together), then:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it, in bfloat16 and float32, with
   the kernel's, the plain version's and (where one PyTorch call computes
   the same function) the library call's time; the int8 attention kernels
   read pages quantized by page_quant from random rows; then the cost of
   the plain int8 page write (page_quant.write_rows) at the decode shape;
2. agree: a 2-layer tiny Llama in float32 with the same seeded weights on
   the CPU (plain versions) and on the card (kernels) — generate_batch
   with prefix cache, chunked prefill and mixed steps, generate_batch with
   cold prompts that fit the chunk (dense admission) beside a prefix hit,
   and generate with its KV cache must give the same greedy tokens; then
   the same two workloads and a fork mid-decode over int8 KV pages;
3. serve: Llama-2-7B geometry in bfloat16 with random weights from a seed
   (all 32 layers) serves 8 requests of 300-900 tokens through
   generate_batch (chunked prefill, a prefix hit, mixed steps); every
   kernel of that path must launch, and a prefix-cache hit must occur;
   then a window of the same workload on a fresh engine runs under
   torch.profiler for the device time by kernel;
4. serve:dense: the same model serves 8 cold requests of 64-256 tokens,
   which the engine admits through the dense prefill (flash attention and
   fused RoPE); then one dense admission of the same workload on a fresh
   engine runs under torch.profiler;
5. serve:int8 and serve:dense:int8: the two workloads again with
   kv_dtype="int8" (int8 pools, the int8 attention kernels), each beside
   the share of its generated tokens that differ from its bf16 twin's
   (printed, not checked: the weights are random), then profiled as
   their twins are.

Each serving run's launch counts are set to 0 just before it and read just
after it; every kernel of its path must have launched, and the int8 runs
must launch the float paged attention kernels 0 times. Then it prints
the card's name and power limit, one JSON line with every kernel's
numbers, and as the last line {"ok": true, "device": {...}}. Any failure
raises and exits non-zero without that line. Without a CUDA card it exits
2 before doing anything.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor-core bf16; fp32 non-tensor
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def check_ragged(K, dev, dtype, h_kv, rng, int8=False):
    # mixed rows at the serving shapes: a suffix chunk after a 300-token
    # prefix, a first chunk ending mid-page, a decode row, a dummy row
    c, q_max, h, d, page, p_max = 4, 256, 32, 128, 16, 256
    rows = [(556, 256, False), (200, 200, False), (777, 1, False),
            (1, 1, True)]
    kp, vp, bt = _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max)
    ctx = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal(
        (c, q_max, h, d), dtype=np.float32)).to(dev, dtype)
    if int8:
        fn, plain = K.ragged_paged_attention_int8, \
            K.ragged_paged_attention_int8_plain
    else:
        fn, plain = K.ragged_paged_attention, K.ragged_paged_attention_plain
    pools = _int8_pools(kp, vp) if int8 else (kp, vp)
    got = fn(q, *pools, bt, ctx, ql)
    want = plain(q, *pools, bt, ctx, ql)
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
    return {"got": got, "want": want, "err": err, "flops": flops,
            "bytes": nbytes,
            "ms": _time_ms(lambda: fn(q, *pools, bt, ctx, ql)),
            "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx, ql),
                                 ITERS // 10),
            "library_ms": None}


def check_decode(K, dev, dtype, rng, h_kv=32, int8=False):
    b, h, d, page, p_max = 4, 32, 128, 16, 256
    lens = [1000, 517, 64, 1]
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
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 4 * sum(lens) * h * d, "bytes": nbytes,
            "ms": _time_ms(lambda: fn(q, *pools, bt, ctx)),
            "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx),
                                 ITERS // 10),
            "library_ms": None}


def check_rms(K, dev, dtype, rng):
    t, hid, eps = 1024, 4096, 1e-6
    x = torch.from_numpy(rng.standard_normal(
        (t, hid), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
        hid, dtype=np.float32)).to(dev, dtype)
    got = K.rms_norm(x, w, eps)
    want = K.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    elt = x.element_size()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 4 * x.numel(),
            "bytes": 2 * x.numel() * elt + hid * w.element_size(),
            "ms": _time_ms(lambda: K.rms_norm(x, w, eps)),
            "plain_ms": _time_ms(lambda: K.rms_norm_plain(x, w, eps)),
            "library_ms": _time_ms(lambda: torch.nn.functional.rms_norm(
                x, (hid,), w, eps))}


def check_swiglu(K, dev, dtype, rng):
    t, f = 1024, 11008
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


def check_flash(K, dev, dtype, rng, b, s_q, s_k, h, h_kv, d=128,
                library=True):
    """Causal flash attention. The library call is PyTorch's
    scaled_dot_product_attention on [B, H, S, D] views (its causal mask is
    top-left aligned, so it is timed only where S_q = S_k)."""
    q = torch.from_numpy(rng.standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    got, lse = K.flash_attention_fwd(q, k, v, causal=True)
    want, want_lse = K.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    blind = max(0, s_q - s_k)              # rows that see no key
    if blind and float(got[:, :blind].float().abs().max()) != 0.0:
        raise AssertionError("flash: rows with no visible key are not 0")
    finite = want_lse > -1e29
    lse_err = float((lse - want_lse)[finite].abs().max())
    if lse_err > 1e-3 or not bool((lse[~finite] <= -1e29).all()):
        raise AssertionError(f"flash: lse disagrees with the plain version "
                             f"(max abs err {lse_err})")
    elt = q.element_size()
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = _time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                    enable_gqa=h != h_kv))
    return {"got": got, "want": want, "err": _max_err(got, want),
            "lse_err": lse_err,
            "flops": 4 * b * h * d * _causal_pairs(s_q, s_k),
            "bytes": (2 * q.numel() + 2 * k.numel()) * elt + lse.numel() * 4,
            "ms": _time_ms(lambda: K.flash_attention_fwd(q, k, v,
                                                         causal=True)),
            "plain_ms": _time_ms(lambda: K.flash_attention_fwd_plain(
                q, k, v, causal=True), ITERS // 10),
            "library_ms": lib}


def check_rope(K, dev, dtype, rng):
    """RoPE on the dense admission's q: [4, 256, 32, 128] with the
    model's float32 [256, 128] tables."""
    b, s, h, d = 4, 256, 32, 128
    x = torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype)
    cos = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    sin = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    got = K.fused_rope(x, cos, sin)
    want = K.fused_rope_plain(x, cos, sin)
    torch.cuda.synchronize()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 3 * x.numel(),
            "bytes": 2 * x.numel() * x.element_size() + 2 * cos.numel() * 4,
            "ms": _time_ms(lambda: K.fused_rope(x, cos, sin)),
            "plain_ms": _time_ms(lambda: K.fused_rope_plain(x, cos, sin)),
            "library_ms": None}


def _within(name, res, dtype):
    """Tolerances: float32 1e-4 absolute for every kernel (the kernels and
    the plain versions sum in other orders); bfloat16 2e-2 absolute for
    attention (outputs of magnitude < 1, one bf16 rounding of each side)
    and one bf16 ulp of the plain result for the elementwise kernels
    (both round one float32 value that differs in its last bits; RoPE
    rounds in the same order on both sides and is expected exact)."""
    if dtype == torch.float32:
        return res["err"] <= TOL[dtype], f"<= {TOL[dtype]}"
    if name in ("rms_norm", "swiglu", "fused_rope"):
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
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
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
        ]
        if dtype == torch.float32:
            # bottom-right causal alignment; rows that see no key
            cases += [
                ("flash_attention[bottom_right]", lambda: check_flash(
                    K, dev, dtype, rng, 1, 100, 300, 32, 32, library=False)),
                ("flash_attention[q_longer]", lambda: check_flash(
                    K, dev, dtype, rng, 1, 300, 100, 32, 32, library=False)),
            ]
        for name, run in cases:
            res = run()
            base = name.split("[")[0]
            ok, tol = _within(base, res, dtype)
            bound, by = _bound_ms(res["bytes"], res["flops"], dtype)
            lib = res["library_ms"]
            lse = f" lse_err={res['lse_err']:.3e}" if "lse_err" in res else ""
            print(f"[kernels] {name:35s} {str(dtype)[6:]:9s} "
                  f"max_abs_err={res['err']:.3e} ({tol}){lse} "
                  f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                  f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
                  f"bound_ms={bound:.4f} ({by})", flush=True)
            if not ok:
                raise AssertionError(f"{name} {dtype}: max_abs_err "
                                     f"{res['err']} not {tol}")
            if dtype == torch.bfloat16 and name == base:
                out[name] = {"max_abs_err": res["err"], "ms": res["ms"],
                             "plain_ms": res["plain_ms"], "bound_ms": bound,
                             "bound_by": by, "library_ms": lib}
            del res
        torch.cuda.empty_cache()
    measure_write_rows(dev)
    return out


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

def _nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    waited = _build.build_all()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in waited.items()})}"
          f" total_s={time.perf_counter() - t0:.2f}", flush=True)
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    records = phase_kernels(K, dev)
    phase_agree(dev)
    phase_agree_int8(dev)
    model = _serving_model(dev)
    serve, serve_out = phase_serve(K, model)
    dense, dense_out = phase_serve_dense(K, model)
    serve8, _ = phase_serve(K, model, kv_dtype="int8", twin=serve_out)
    dense8, _ = phase_serve_dense(K, model, kv_dtype="int8", twin=dense_out)
    launches = {k: serve[k] + dense[k] + serve8[k] + dense8[k]
                for k in K.KERNELS}
    _require_launched("all serving runs", launches, K.KERNELS)

    name_power = _nvidia_smi()
    print(name_power)
    kernels = []
    for name, (_fn, source, replaces) in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **records[name]})
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


def phase_serve(K, model, kv_dtype=None, twin=None):
    """8 requests of 300-900 tokens (requests 0 and 5 share a 512-token
    prefix) through generate_batch, 32 greedy tokens each, on float pools
    or (kv_dtype="int8") int8 pools. Returns the kernels' launch counts
    over that run and the generated tokens."""
    cfg = model.config
    tag = "serve" if kv_dtype is None else "serve:int8"
    if kv_dtype is not None:
        _fresh_pools(model)
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    n_new = 32
    eng = model.get_engine(**kw)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_batch(prompts, max_new_tokens=n_new, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = eng.stats
    ttft = sorted(eng.ttft_s)
    gen = [o[len(p):] for o, p in zip(out, prompts)]
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']}")
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
    _print_twin_diff(tag, gen, twin)
    for o, p, g in zip(out, prompts, gen):
        if len(o) != len(p) + n_new or not np.array_equal(o[:len(p)], p):
            raise AssertionError("a result is not prompt + 32 new tokens")
        if g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError("generated token out of the vocabulary")
    if len(set(np.concatenate(gen).tolist())) < 2:
        raise AssertionError("degenerate output: one token everywhere")
    if st["prefix_hits"] < 1:
        raise AssertionError("the serving run saw no prefix-cache hit")
    if kv_dtype is None:
        _require_launched(tag, launches, SERVE_KERNELS)
    else:
        _require_launched(tag, launches, SERVE_INT8_KERNELS)
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _profile_serve(model, prompts, kw, n_new,
                   "profile" if kv_dtype is None else "profile:int8")
    return launches, gen


# the kernels each serving run's path launches
SERVE_KERNELS = ("ragged_paged_attention", "paged_decode_attention",
                 "rms_norm", "swiglu")
DENSE_KERNELS = ("flash_attention", "fused_rope", "paged_decode_attention",
                 "rms_norm", "swiglu")
SERVE_INT8_KERNELS = ("ragged_paged_attention_int8",
                      "paged_decode_attention_int8", "rms_norm", "swiglu")
DENSE_INT8_KERNELS = ("flash_attention", "fused_rope",
                      "paged_decode_attention_int8", "rms_norm", "swiglu")
# what an int8 run must never launch: no float pool behind the flag
FLOAT_PAGED_KERNELS = ("ragged_paged_attention", "paged_decode_attention")


def _require_launched(tag, launches, names):
    idle = [k for k in names if launches[k] <= 0]
    if idle:
        raise AssertionError(f"[{tag}] kernels never launched on the path: "
                             f"{idle}")


def _require_idle(tag, launches, names):
    busy = {k: launches[k] for k in names if launches[k] != 0}
    if busy:
        raise AssertionError(f"[{tag}] float paged kernels launched in an "
                             f"int8 run: {busy}")


def phase_serve_dense(K, model, kv_dtype=None, twin=None):
    """The same model serves 8 cold requests of 64-256 tokens (no shared
    prefix) through generate_batch, 32 greedy tokens each: every prompt
    fits the chunk of 256, so the engine admits them through the dense
    prefill. Returns the kernels' launch counts over that run and the
    generated tokens."""
    cfg = model.config
    tag = "serve:dense" if kv_dtype is None else "serve:dense:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(64, 257))).astype(np.int32)
               for _ in range(8)]
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              kv_dtype=kv_dtype)
    n_new = 32
    shapes = []                 # (c, s_pad) of every dense admission
    prefill = model.paged_prefill

    def recorded_prefill(ids, lengths):
        shapes.append(tuple(ids.shape))
        return prefill(ids, lengths)

    model.paged_prefill = recorded_prefill
    eng = model.get_engine(**kw)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate_batch(prompts, max_new_tokens=n_new, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    del model.paged_prefill
    st = eng.stats
    ttft = sorted(eng.ttft_s)
    gen = [o[len(p):] for o, p in zip(out, prompts)]
    admits = max(st["prefill_admits"], 1)
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']}")
    print(f"[{tag}] ttft_s p50={ttft[len(ttft) // 2]:.4f} "
          f"max={ttft[-1]:.4f} (host clock, from submission)")
    print(f"[{tag}] prefill_admits={st['prefill_admits']} "
          f"buckets={shapes} prefill_tokens={st['prefill_tokens']} "
          f"prefill_s_per_admit={st['prefill_s'] / admits:.4f}; "
          f"decode chunks={st['decode_chunks']} tokens="
          f"{st['decode_tokens']} tokens_per_s="
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.2f}; "
          f"ragged steps={st['ragged_steps']} "
          f"preemptions={st['preemptions']}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _print_twin_diff(tag, gen, twin)
    for o, p, g in zip(out, prompts, gen):
        if len(o) != len(p) + n_new or not np.array_equal(o[:len(p)], p):
            raise AssertionError("a result is not prompt + 32 new tokens")
        if g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError("generated token out of the vocabulary")
    if st["prefill_admits"] < 2 or not shapes or shapes[0] != (4, 256):
        raise AssertionError(f"expected >= 2 dense admissions, the first "
                             f"with (c, s_pad) = (4, 256); got "
                             f"{st['prefill_admits']}, {shapes}")
    if kv_dtype is None:
        _require_launched(tag, launches, DENSE_KERNELS)
    else:
        _require_launched(tag, launches, DENSE_INT8_KERNELS)
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _profile_admission(model, prompts, kw, n_new,
                       "profile:dense" if kv_dtype is None
                       else "profile:dense:int8")
    return launches, gen


def _print_profile(tag, prof, wall, note):
    """Device time by kernel from a finished torch.profiler window, and
    the device's busy share of the window's wall time."""
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
    print(f"[{tag}] {note}: wall_s={wall:.3f} device_busy_s={busy:.3f} "
          f"idle_share={1 - busy / wall:.3f} kernel_launches={n_kernels}")
    for us, key, count in rows[:14]:
        print(f"[{tag}] {us / 1e3:10.2f} ms {100 * us / 1e6 / busy:5.1f}% "
              f"x{count:<6d} {key[:90]}")


def _profile_admission(model, prompts, kw, n_new, tag):
    """The dense workload again on a fresh engine: its first dense
    admission (the `_admit` call of engine step 0: c = 4, s_pad = 256)
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import GenerationEngine

    eng = GenerationEngine(model, **kw)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    admit = eng._admit
    walls = []

    def profiled_admit(admissions):
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        admit(admissions)                 # ends in a host sync
        walls.append(time.perf_counter() - t0)
        prof.stop()

    eng._admit = profiled_admit
    with torch.inference_mode():
        for p in prompts:
            eng.add_request(p, max_new_tokens=n_new)
        eng.step()
    if len(walls) != 1:
        raise AssertionError("engine step 0 made no single dense admission")
    _print_profile(tag, prof, walls[0],
                   f"one dense admission (c=4, s_pad=256, "
                   f"{eng.stats['prefill_tokens']} prompt tokens)")


PROFILE_STEPS = (2, 8)   # engine steps [from, to) of the profiled window


def _profile_serve(model, prompts, kw, n_new, tag):
    """The same workload again on a fresh engine, with engine steps
    PROFILE_STEPS under torch.profiler: device time by kernel and the
    device's busy share of the window's wall time. (Profiled separately so
    the timed run above carries no tracing cost; a window rather than the
    whole run keeps the profiler's post-processing short.)"""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import GenerationEngine

    eng = GenerationEngine(model, **kw)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with torch.inference_mode():
        for p in prompts:
            eng.add_request(p, max_new_tokens=n_new)
        n = 0
        while eng.has_work():
            if n == PROFILE_STEPS[0]:
                torch.cuda.synchronize()
                before = dict(eng.stats)
                prof.start()
                t0 = time.perf_counter()
            eng.step()
            n += 1
            if n == PROFILE_STEPS[1]:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.stop()
                after = dict(eng.stats)
    if n < PROFILE_STEPS[1]:
        raise AssertionError(f"the workload took {n} engine steps, fewer "
                             f"than the profiled window {PROFILE_STEPS}")
    window = {k: after[k] - before[k] for k in
              ("ragged_steps", "decode_chunks", "decode_tokens",
               "mixed_decode_tokens")}
    _print_profile(tag, prof, wall,
                   f"engine steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1} "
                   f"of {n} {json.dumps(window)}")


if __name__ == "__main__":
    sys.exit(main())
