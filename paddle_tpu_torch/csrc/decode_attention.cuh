// Paged decode attention: one query token per sequence attends over its KV
// context stored in fixed-size pages, found through a per-sequence block
// table. The kernel template, shared by the float-page entry
// (decode_attention.cu) and the int8-page entry (quantized_attention.cu).
//
//   q          [B, H, D]            the new token's queries
//   k/v pages  [N, page, H_kv, D]   the layer's page pools: q's type, or
//                                   int8 codes with k/v scales [N] f32
//   block_tables [B, P] int32, context_lens [B] int32 (tokens visible,
//   the new one included; 0 for an idle slot, which writes 0)
//   out        [B, H, D]
//   ws         float32 workspace [B * H * splits * (D + 2)] (partial
//              accumulators, then their running maxima and normalizers),
//              null when the plan has one split
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py:
// _decode_kernel (paged_decode_attention). What bounds it on the H100:
// memory. Each visible key and value row is read once and used by the
// rep = H / H_kv queries of its group, 4 * rep * D operations per pair of
// rows, far below the card's ~295 operations per byte; the floor is the
// context's K and V bytes over 3.35 TB/s.
//
// Design: split-K over pages (flash-decoding). The grid is (splits,
// H_kv * row groups, B): each block takes one range of pages_per_split
// pages of one (sequence, KV head) and up to DECODE_MAX_REP query rows of
// its group. The plan (decode_split_plan) comes from static shapes only --
// B, H, H_kv, the table width P and the page size -- never from
// context_lens, which the engine keeps on the device: no launch reads a
// device value on the host. A block whose range starts at or past its
// context reads nothing and writes an empty partial (m = NEG_INF, l = 0).
// Inside a block, lane groups of lg lanes each hold one key: a lane loads
// 16 bytes of the key row and 16 of the value row at a time (8 bf16/f16
// values, 4 float32; int8 rows 8 codes, 8 bytes), so a warp moves 32 / lg
// keys per instruction, and U keys' loads are issued before any of them is
// used. The group's query rows sit in registers, each score is a
// shuffle sum inside the lane group, and each lane group keeps its own
// online softmax (running max, normalizer, float32 accumulator over its
// slice of D) in registers. At the end the lane groups merge by shuffles,
// the warps through shared memory, once. With one split the block then
// writes out; otherwise it writes its partial, and decode_merge_kernel
// (one block a query row) combines the partials of the row's live ranges:
// m = max m_i, l = sum exp(m_i - m) l_i, acc = sum exp(m_i - m) acc_i,
// out = acc / max(l, L_EPS), which writes 0, not NaN, for a row whose
// partials are all empty. A call is two launches (one with one split); the
// merge is a programmatic dependent launch, so its blocks are scheduled
// while the split kernel's last ones run and wait for their writes.
// Masking goes by position (t < context), never by page id: tables are
// padded with the trash page 0, and pages at or past the context are never
// read. Rows of D that are not a whole number of 16-byte vectors, or pools
// not aligned to them, take the same kernel with one element a lane step
// (the scalar path), chosen in launch_decode.
//
// int8 pages (replacing paddle_tpu/ops/pallas/quantized_attention.py:
// _decode_int8_kernel): KV is int8 and the scale pointers are set. The
// dequant multipliers scale[pid] * (1/127) are loaded beside each key's
// codes (one 4-byte load a page's keys share, from L1); the K multiplier
// scales the key's score (with the softmax scale) and the V multiplier its
// probability, one multiply a key instead of one an element. No float pool
// exists, and the bound is the int8 context bytes, half the bf16 ones.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr int DECODE_THREADS = 128;
constexpr int DECODE_WARPS = DECODE_THREADS / 32;
// query rows a block holds in registers; a larger group is split into row
// groups of this many, each its own block reading the same pages
constexpr int DECODE_MAX_REP = 8;
// A split covers as many keys as the launch has (sequence, KV head, row
// group) triples, so that a full table makes about P * page blocks whatever
// the batch, and at least DECODE_MIN_SPLIT_TOKENS, so that a block's work
// outweighs its fixed cost; at most DECODE_MAX_SPLITS partials a row.
constexpr int DECODE_MIN_SPLIT_TOKENS = 64;
constexpr int DECODE_MAX_SPLITS = 64;

// The split plan from static shapes: *splits ranges of *pps pages (the
// last one shorter when P is no multiple). Mirrored by split_plan in
// paddle_tpu_torch/ops/kernels/decode_attention.py, which sizes the
// workspace; the wrapper holds the two equal.
inline void decode_split_plan(int B, int H, int Hkv, int P, int page,
                              int* splits, int* pps) {
  if (P <= 0 || page <= 0 || Hkv <= 0 || B <= 0) {
    *splits = 1;
    *pps = P > 0 ? P : 1;
    return;
  }
  const int rep = H / Hkv;
  const long long groups = (rep + DECODE_MAX_REP - 1) / DECODE_MAX_REP;
  const long long heads = (long long)B * Hkv * (groups > 0 ? groups : 1);
  const long long tokens =
      heads > DECODE_MIN_SPLIT_TOKENS ? heads : DECODE_MIN_SPLIT_TOKENS;
  long long per = tokens / page;
  if (per < 1) per = 1;
  if (per > P) per = P;
  long long n = (P + per - 1) / per;
  if (n > DECODE_MAX_SPLITS) {
    per = (P + DECODE_MAX_SPLITS - 1) / DECODE_MAX_SPLITS;
    n = (P + per - 1) / per;
  }
  *splits = (int)n;
  *pps = (int)per;
}

template <typename T, typename KV, int VE, int NV, int REP>
__global__ void __launch_bounds__(DECODE_THREADS) decode_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ cl, T* __restrict__ out, float* __restrict__ ws,
    int H, int Hkv, int D, int page, int P, int pps, int lg, float scale) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int U = REP <= 2 ? 4 : 2;     // keys a lane group loads at once
  extern __shared__ float sm[];
  // the merge (launched as this grid's programmatic dependent) may start
  // its prologue now; it waits for this grid's writes before reading them
  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x, splits = gridDim.x;
  const int groups = gridDim.y / Hkv;
  const int g = blockIdx.y / groups, rg = blockIdx.y % groups;
  const int64_t b = blockIdx.z;
  const int rep = H / Hkv;
  const int r0 = rg * DECODE_MAX_REP;
  const int nr = min(REP, rep - r0);
  const int64_t row0 = b * H + g * rep + r0;  // first query row, flattened
  const int64_t rows = (int64_t)gridDim.z * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int* pid_s = reinterpret_cast<int*>(sm);          // [pps]
  float* m_w = reinterpret_cast<float*>(pid_s + pps);  // [WARPS][REP]
  float* l_w = m_w + DECODE_WARPS * REP;            // [WARPS][REP]
  float* acc_w = l_w + DECODE_WARPS * REP;          // [WARPS][REP][D]

  const int ctx = cl[b];
  const int p0 = split * pps;
  const int p1 = min(p0 + pps, P);
  // the range's table entries (not its pages) load while ctx does
  for (int i = tid; i < p1 - p0; i += DECODE_THREADS)
    pid_s[i] = bt[b * P + p0 + i];
  const int t0 = p0 * page;
  const int n = min(ctx, p1 * page) - t0;   // visible keys of this split

  float* ws_m = ws + rows * splits * D;
  float* ws_l = ws_m + rows * splits;
  if (n <= 0) {                       // nothing visible: an empty partial
    if (ws == nullptr) {
      for (int i = tid; i < nr * D; i += DECODE_THREADS)
        out[row0 * D + i] = from_f<T>(0.f);
    } else if (tid < nr) {
      ws_m[(row0 + tid) * splits + split] = NEG_INF;
      ws_l[(row0 + tid) * splits + split] = 0.f;
    }
    return;
  }

  const int C = D / VE;                      // vectors in a row
  const int gl = lane & (lg - 1);            // lane within its group
  const int kslot = warp * (32 / lg) + lane / lg;
  const int kstride = DECODE_WARPS * (32 / lg);
  const int step = U * kstride;              // keys of the block per step
  // int8: the page's dequant multipliers, scale[pid] / 127, are read with
  // its keys (the K one folded with the softmax scale)
  const float kscale = Q8 ? INV_QMAX * scale : scale;

  float qv[REP][NV][VE];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = gl + j * lg;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qv[r][j][e] = (r < nr && c < C)
                          ? to_f(q[(row0 + r) * D + c * VE + e]) : 0.f;
    }
  float acc[REP][NV][VE];
  float m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][j][e] = 0.f;
  }

  __syncthreads();                           // pid_s

  for (int base = 0; base < n; base += step) {
    // the step's U keys of this lane group: every load issued before use
    Vec<KV, VE> kr[U][NV], vr[U][NV];
    float kmul[U], vmul[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * kstride + kslot;
      ok[u] = t < n;
      kmul[u] = 0.f;
      vmul[u] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        kr[u][j].zero();
        vr[u][j].zero();
      }
      if (ok[u]) {
        const int pi = t / page;
        const int pid = pid_s[pi];
        const int64_t off =
            (((int64_t)pid * page + (t - pi * page)) * Hkv + g) * D;
        kmul[u] = Q8 ? ks[pid] * kscale : kscale;
        vmul[u] = Q8 ? vs[pid] * INV_QMAX : 1.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = gl + j * lg;
          if (c < C) {
            kr[u][j].load(kp + off + c * VE);
            vr[u][j].load(vp + off + c * VE);
          }
        }
      }
    }
    float s[U][REP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) a += qv[r][j][e] * kr[u][j].get(e);
        for (int o = lg >> 1; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        s[u][r] = ok[u] ? a * kmul[u] : NEG_INF;
      }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float alpha = expf(m[r] - mx);   // 1 while both are NEG_INF
      m[r] = mx;
      float pw[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[u][r] - mx) : 0.f;
        psum += p;
        pw[u] = p * vmul[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          float a = acc[r][j][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a += pw[u] * vr[u][j].get(e);
          acc[r][j][e] = a;
        }
    }
  }

  // merge the warp's lane groups (the same slice of D, other keys)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mw = m[r];
    for (int o = lg; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = expf(m[r] - mw);
    float lw = l[r] * f;
    for (int o = lg; o < 32; o <<= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        float a = acc[r][j][e] * f;
        for (int o = lg; o < 32; o <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[r][j][e] = a;
      }
    if (lane < lg) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = gl + j * lg;
        if (c < C) {
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc_w[(warp * REP + r) * D + c * VE + e] = acc[r][j][e];
        }
      }
    }
    if (lane == 0) {
      m_w[warp * REP + r] = mw;
      l_w[warp * REP + r] = lw;
    }
  }
  __syncthreads();

  // merge the warps, then write out (one split) or the partial
  for (int i = tid; i < nr * D; i += DECODE_THREADS) {
    const int r = i / D, d = i - r * D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) mm = fmaxf(mm, m_w[w * REP + r]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float f = expf(m_w[w * REP + r] - mm);
      a += f * acc_w[(w * REP + r) * D + d];
      ll += f * l_w[w * REP + r];
    }
    if (ws == nullptr) {
      out[(row0 + r) * D + d] = from_f<T>(a / fmaxf(ll, L_EPS));
    } else {
      const int64_t pr = (row0 + r) * splits + split;
      ws[pr * D + d] = a;
      if (d == 0) {
        ws_m[pr] = mm;
        ws_l[pr] = ll;
      }
    }
  }
}

// One block per query row: combine the partials of the ranges that start
// before the row's context (the others are empty and never read) and write
// out. One warp weighs the partials, w_i = exp(m_i - m), into shared
// memory; every thread then sums its columns over them with independent
// loads. A partial with l = 0 weighs 0 whatever its m, and a row with no
// visible key (an idle slot) writes 0.
template <typename T>
__global__ void __launch_bounds__(DECODE_THREADS) decode_merge_kernel(
    const float* __restrict__ ws, const int* __restrict__ cl,
    T* __restrict__ out, int H, int splits, int span, int cap, int D) {
  __shared__ float w_s[DECODE_MAX_SPLITS];
  __shared__ float l_s;
  const int64_t row = blockIdx.x, rows = gridDim.x;
  const int ctx = min(cl[row / H], cap);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the partials
  const int n = ctx > 0 ? min((ctx + span - 1) / span, splits) : 0;
  const float* ms = ws + rows * splits * D + row * splits;
  const float* ls = ms + rows * splits;
  const float* acc = ws + row * splits * D;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = NEG_INF;
    for (int i = lane; i < n; i += 32)
      if (ls[i] > 0.f) mx = fmaxf(mx, ms[i]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float w = ls[i] > 0.f ? expf(ms[i] - mx) : 0.f;
      w_s[i] = w;
      l += w * ls[i];
    }
    l = warp_sum(l);
    if (lane == 0) l_s = l;
  }
  __syncthreads();
  const float l = fmaxf(l_s, L_EPS);
  for (int d = threadIdx.x; d < D; d += DECODE_THREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float w = w_s[i], v = acc[(int64_t)i * D + d];
      a += w > 0.f ? w * v : 0.f;
    }
    out[row * D + d] = from_f<T>(a / l);
  }
}

template <typename T, typename KV, int VE, int NV, int REP>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const float* k_scales, const float* v_scales,
                 const int* block_tables, const int* context_lens, void* out,
                 float* ws, int B, int H, int Hkv, int D, int page, int P,
                 int splits, int pps, int lg, float scale, cudaStream_t s) {
  const int groups = (H / Hkv + DECODE_MAX_REP - 1) / DECODE_MAX_REP;
  const size_t smem = sizeof(float) * ((size_t)pps +
                                       2 * DECODE_WARPS * REP +
                                       (size_t)DECODE_WARPS * REP * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, KV, VE, NV, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_split_kernel<T, KV, VE, NV, REP>
      <<<dim3(splits, Hkv * groups, B), DECODE_THREADS, smem, s>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages, k_scales,
      v_scales, block_tables, context_lens, (T*)out, splits > 1 ? ws : nullptr,
      H, Hkv, D, page, P, pps, lg, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  // a programmatic dependent launch: the merge's blocks are scheduled
  // while the split kernel's last blocks run, and wait for its writes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((int64_t)B * H));
  cfg.blockDim = dim3(DECODE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_merge_kernel<T>, (const float*)ws,
                         context_lens, (T*)out, H, splits, pps * page,
                         P * page, D);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int VE, int NV>
int launch_rep(int rep, const void* q, const void* k_pages,
               const void* v_pages, const float* k_scales,
               const float* v_scales, const int* block_tables,
               const int* context_lens, void* out, float* ws, int B, int H,
               int Hkv, int D, int page, int P, int splits, int pps, int lg,
               float scale, cudaStream_t s) {
#define PTT_DECODE_REP(R)                                                   \
  return launch_split<T, KV, VE, NV, R>(                                    \
      q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,  \
      out, ws, B, H, Hkv, D, page, P, splits, pps, lg, scale, s)
  if (rep <= 1) PTT_DECODE_REP(1);
  if (rep <= 2) PTT_DECODE_REP(2);
  if (rep <= 4) PTT_DECODE_REP(4);
  PTT_DECODE_REP(8);
#undef PTT_DECODE_REP
}

// One call: the split kernel and, with more than one split, the merge;
// returns the CUDA error code. ws must hold B * H * splits * (D + 2)
// floats when the plan has more than one split.
template <typename T, typename KV>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scales, const float* v_scales,
                  const int* block_tables, const int* context_lens, void* out,
                  float* ws, int B, int H, int Hkv, int D, int page, int P,
                  float scale, cudaStream_t s) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || page <= 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  int splits, pps;
  decode_split_plan(B, H, Hkv, P, page, &splits, &pps);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  // the vector path: whole 16-byte vectors (int8: 8 codes, 8 bytes) of
  // rows at aligned addresses; else one element a lane step
  constexpr int VEC = sizeof(KV) == 4 ? 4 : 8;
  constexpr uintptr_t ALIGN = VEC * sizeof(KV);
  const bool vec = D % VEC == 0 &&
                   ((uintptr_t)k_pages % ALIGN) == 0 &&
                   ((uintptr_t)v_pages % ALIGN) == 0;
  const int ve = vec ? VEC : 1;
  const int C = D / ve;
  int lg = 1;
  while (lg < C && lg < 32) lg <<= 1;
  const int nv = (C + lg - 1) / lg;
#define PTT_DECODE_PATH(V, N)                                               \
  return launch_rep<T, KV, V, N>(rep, q, k_pages, v_pages, k_scales,        \
                                 v_scales, block_tables, context_lens, out, \
                                 ws, B, H, Hkv, D, page, P, splits, pps, lg,\
                                 scale, s)
  if (vec && nv == 1) PTT_DECODE_PATH(VEC, 1);
  if (vec && nv == 2) PTT_DECODE_PATH(VEC, 2);
  if (!vec && nv <= 8) PTT_DECODE_PATH(1, 8);
#undef PTT_DECODE_PATH
  return (int)cudaErrorInvalidValue;      // D too wide for either path
}

}  // namespace ptt
