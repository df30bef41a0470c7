// Flash attention, forward: blocked online-softmax attention over dense
// q/k/v in paddle layout, emitting the per-row logsumexp.
//
//   q    [B, S_q, H, D]      k, v [B, S_k, H_kv, D]     (H % H_kv == 0)
//   out  [B, S_q, H, D]      lse  [B, H, S_q] float32
//
// Query i of head h sees key t when t < S_k and, under `causal`, when
// i + (S_k - S_q) >= t (bottom-right alignment, paddle's semantics). Query
// head h reads KV head h / (H / H_kv): GQA goes by index, K and V are never
// repeated. A row that sees no key (causal with S_q > S_k) writes 0 and
// lse = NEG_INF + log(L_EPS), which is -1e30 in float32, never NaN.
//
// Flashmask (ptt_flashmask_attention_fwd): up to two intervals of masked
// query rows per key, bounds [B, kh, S_k] int32 with kh 1, H_kv or H (the
// kernel picks the bound row of its query head). Query i cannot see key t
// when start[t] <= i < end[t] or start2[t] <= i < end2[t], in query-row
// coordinates, on top of the tests above. A tile's bounds are staged in
// shared memory beside its K tile. The count of intervals (0, 1, 2) is a
// template argument of the one kernel: with 0 the bounds are never read
// and the predicate compiles away. Tiles that the ranges mask whole are
// still computed (only the causal skip applies).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:
// _flash_fwd_bhsd / _fwd_kernel (flash_attention_fwd; with the mask
// operands and _range_mask, flashmask_attention_fwd), and the JAX
// package's Pallas-on-GPU lowering of the same function,
// paddle_tpu/ops/primitive/lowering_gpu.py: _flash_fwd_gpu. What bounds it
// on the H100: operations. A causal prefill of S tokens does ~2 * S^2 * D
// operations per head against ~4 * S * D * 2 bytes of q, k, v and out, so
// at S = 256 the floor is the bytes (33.6 MB over 3.35 TB/s) and from
// S ~ 1k on the causal operations over 989 TFLOP/s.
//
// Design (first version): one block per (batch x head, tile of BQ = 64
// query rows). The tile's queries are staged in shared memory as float32;
// K and V stream through shared memory in tiles of BK = 32 keys, and the
// loop ends at the last key the tile's last real query sees, so tiles
// wholly above the causal diagonal are never read (tiles.causal_block_skip).
// Masking goes by position against S_k; nothing is padded or read past
// S_q or S_k. 256 threads form 16 row groups of 16 lanes: a thread owns 4
// query rows, and for them 2 keys of each score tile and D / 16 columns of
// the float32 accumulator, which stays in registers. Row maxima and sums
// reduce over the 16 lanes by shuffles. P stays float32 for the PV product
// (as in _flash_fwd_gpu; the TPU kernel rounds P to v's type). The
// products run on the CUDA cores in float32, far below the tensor-core
// rate; the planned redesign stages K/V with TMA and runs QK^T and PV on
// wgmma. Tiles are issued heaviest first (the last query tiles of a causal
// launch see the most keys).
#include "common.cuh"
#include "flash_mask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int LANES = 16;             // threads sharing one row group
constexpr int RPT = 4;                // query rows per thread
constexpr int KPT = 2;                // keys per thread in a score tile
constexpr int BQ = (kThreads / LANES) * RPT;   // 64 query rows per block
constexpr int BK = LANES * KPT;                 // 32 keys per tile

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

using ptt::Bounds;
using ptt::bound_row;
using ptt::range_visible;
using ptt::stage_bounds;

// NJ: accumulator columns per lane, at least ceil(D / 16); NM: masked
// row intervals per key (0: no range mask, mb unused)
template <typename T, int NJ, int NM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Bounds mb, int Sq, int Sk, int H,
                 int Hkv, int D, float scale, int causal) {
  extern __shared__ float sm[];
  const int DP = D + 1;                 // padded stride: no bank conflicts
  float* q_s = sm;                      // [BQ, DP]
  float* k_s = q_s + BQ * DP;           // [BK, DP]
  float* v_s = k_s + BK * DP;           // [BK, D]
  float* p_s = v_s + BK * D;            // [BQ, BK + 1]
  int* b_s = (int*)(p_s + BQ * (BK + 1));   // [2 * NM, BK] bounds

  const int tid = threadIdx.x;
  const int rg = tid / LANES, lane = tid % LANES;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int off = Sk - Sq;              // bottom-right causal offset

  const int64_t q_stride = (int64_t)H * D;       // between query positions
  const int64_t kv_stride = (int64_t)Hkv * D;    // between key positions
  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Sk * Hkv + g) * D;
  const T* vb = v + ((int64_t)b * Sk * Hkv + g) * D;
  T* ob = out + ((int64_t)b * Sq * H + h) * D;
  const int64_t mrow = NM ? bound_row(mb, b, h, g, H, Sk) : 0;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    q_s[r * DP + d] = qi < Sq ? ptt::to_f(qb[qi * q_stride + d]) : 0.f;
  }

  // keys the tile's last real query can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = ptt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                    // q_s staged; last tile's reads done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int kp = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        kv = ptt::to_f(kb[kp * kv_stride + d]);
        vv = ptt::to_f(vb[kp * kv_stride + d]);
      }
      k_s[t * DP + d] = kv;
      v_s[t * D + d] = vv;
    }
    if constexpr (NM > 0) stage_bounds<NM>(b_s, mb, mrow, k0, BK, Sk);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    // D % 8 == 0: eight columns per step, unrolled in the source (see the
    // PV loop below for why the unrolling is not left to the compiler)
    for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const int d = d0 + dd;
        float qv[RPT], kv[KPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = q_s[(rg * RPT + i) * DP + d];
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          kv[j] = k_s[(lane + j * LANES) * DP + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < KPT; ++j) s[i][j] += qv[i] * kv[j];
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int qi = q0 + r;
      bool ok[KPT];
      float m_cur = ptt::NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + lane + j * LANES;
        ok[j] = kp < Sk && (!causal || qi + off >= kp) &&
                range_visible<NM>(b_s, BK, lane + j * LANES, qi);
        s[i][j] = ok[j] ? s[i][j] * scale : ptt::NEG_INF;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(m_cur));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // a masked key contributes 0 even when the row has seen no key yet
        // (m_new is still NEG_INF there and exp(0) would be 1)
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * (BK + 1) + lane + j * LANES] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // Unrolled by 4 on purpose. Left to itself, nvcc chose per
    // instantiation: one iteration of this loop (32 FFMAs) took 94
    // instructions in the unmasked kernel as it stood before the mask
    // came in and 147 in the same body compiled beside the mask code (the
    // d < D tests kept inside the loop), and the kernel ran 52% slower.
    // Unrolled by 4, every instantiation beats the former unmasked kernel
    // (flash_fwd_ab.py times the versions side by side; PERF.md).
    const int t_end = min(BK, k_end - k0);
#pragma unroll 4
    for (int t = 0; t < t_end; ++t) {
      float p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = p_s[(rg * RPT + i) * (BK + 1) + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + j * LANES;
        if (d < D) {
          const float vv = v_s[t * D + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[i], ptt::L_EPS);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + j * LANES;
      if (d < D) ob[qi * q_stride + d] = ptt::from_f<T>(acc[i][j] / lc);
    }
    if (lane == 0) lse[(int64_t)bh * Sq + qi] = m[i] + logf(lc);
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NJ, int NM>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const Bounds& mb, int B, int Sq, int Sk, int H, int Hkv, int D,
           float scale, int causal, cudaStream_t s) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
       (size_t)BQ * (BK + 1)) + sizeof(int) * 2 * NM * BK;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  auto kern = flash_fwd_kernel<T, NJ, NM>;
  if (int e = allow_smem(kern, smem)) return e;
  kern<<<grid, kThreads, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (T*)out, lse, mb, Sq, Sk, H, Hkv, D,
                                    scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NM>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, const Bounds& mb, int B, int Sq, int Sk, int H,
             int Hkv, int D, float scale, int causal, cudaStream_t s) {
#define PTT_FWD(NJ) return launch<T, NJ, NM>(q, k, v, out, lse, mb, B, Sq, \
    Sk, H, Hkv, D, scale, causal, s)
  if (D <= 16) PTT_FWD(1);
  if (D <= 32) PTT_FWD(2);
  if (D <= 64) PTT_FWD(4);
  if (D <= 128) PTT_FWD(8);
  PTT_FWD(16);
#undef PTT_FWD
}

int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, int D, float scale, int causal, int dtype,
              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      (long long)B * H > 0x7fffffffLL || (Sq + BQ - 1) / BQ > 65535 ||
      !ptt::bounds_ok(mb, nm, H, Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(dtype, T,
    if (nm == 0)
      return launch_d<T, 0>(q, k, v, out, (float*)lse, mb, B, Sq, Sk, H, Hkv,
                            D, scale, causal, s);
    if (nm == 1)
      return launch_d<T, 1>(q, k, v, out, (float*)lse, mb, B, Sq, Sk, H, Hkv,
                            D, scale, causal, s);
    return launch_d<T, 2>(q, k, v, out, (float*)lse, mb, B, Sq, Sk, H, Hkv,
                          D, scale, causal, s))
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int Sq, int Sk, int H, int Hkv,
                                       int D, float scale, int causal,
                                       int dtype, void* stream) {
  const Bounds none = {nullptr, nullptr, nullptr, nullptr, 1};
  return fwd_entry(q, k, v, out, lse, none, 0, B, Sq, Sk, H, Hkv, D, scale,
                   causal, dtype, stream);
}

// start/end (and start2/end2 when nm == 2): [B, kh, Sk] int32
extern "C" int ptt_flashmask_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D,
    float scale, int causal, int dtype, void* stream) {
  const Bounds mb = {(const int*)start, (const int*)end, (const int*)start2,
                     (const int*)end2, kh};
  return fwd_entry(q, k, v, out, lse, mb, nm, B, Sq, Sk, H, Hkv, D, scale,
                   causal, dtype, stream);
}
