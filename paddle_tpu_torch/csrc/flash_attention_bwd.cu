// Flash attention, backward: dq, dk and dv of the forward in
// flash_attention.cu, recomputing the probabilities from the forward's
// per-row logsumexp instead of storing them.
//
//   q, dout [B, S_q, H, D]     k, v, dk, dv [B, S_k, H_kv, D]  (H % H_kv == 0)
//   lse, delta [B, H, S_q] float32 (delta = rowsum(dout * out), computed
//   by the wrapper); dq [B, S_q, H, D]
//
//   P  = exp(S * scale - lse)   (0 where masked)     S = Q K^T
//   dV = P^T dO        dP = dO V^T       dS = P * (dP - delta)
//   dQ = dS K * scale  dK = dS^T Q * scale
//
// Masking is the forward's: query i sees key t when t < S_k and, under
// `causal`, i + (S_k - S_q) >= t (bottom-right alignment); query rows past
// S_q and key rows past S_k add nothing. Under GQA, dK and dV of KV head g
// are the sums over the H / H_kv query heads that read it.
//
// Flashmask (ptt_flashmask_attention_bwd) adds the forward's range mask:
// bounds [B, kh, S_k] int32 (kh 1, H_kv or H), query i cannot see key t
// when start[t] <= i < end[t] or start2[t] <= i < end2[t]. P is zeroed by
// the mask, never by exp, so rows that see no key (lse -1e30) add nothing.
// The dQ kernel stages the bounds of each K tile beside it; the dK/dV
// kernel stages its 64 keys' bounds once per query head of the group,
// since with kh = H the bound row changes with the head. The count of
// intervals (0, 1, 2) is a template argument: with 0 the kernels are the
// unmasked ones.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _flash_bwd_bhsd, its dq pallas_call (:360, body _bwd_dq_kernel) and its
// dk/dv pallas_call (:393, body _bwd_dkv_kernel), and the group sum of
// _flash_core_bwd (with the mask operands and _range_mask, the backward of
// flashmask_attention_fwd, _flashmask_core_bwd). What bounds it on the H100: operations. The function
// does five products over the visible (query, key) pairs, 10 * pairs * D
// operations per head, against ~8 * S * D * 2 bytes of q, k, v, out, dout,
// dq, dk, dv: at S = 2048, D = 128 the causal operations (0.17 ms over 989
// TFLOP/s at [4, 2048, 16, 128]) outweigh the bytes (0.04 ms).
//
// Design (first version): two kernels, no atomics, deterministic.
// - dQ: one block per (batch x head, tile of BQ = 64 queries), heaviest
//   tiles first. Q, dO, lse and delta of the tile stay in shared memory;
//   K and V stream through it in tiles of BK = 32 keys up to the last key
//   the tile's last query sees. A thread owns 4 query rows x 2 keys of
//   each score tile (S and dP together) and D / 16 columns of the float32
//   dQ accumulator, which stays in registers.
// - dK/dV: one block per (batch, KV head, tile of BKV = 64 keys). K and V
//   of the tile stay in shared memory; the block walks the group's query
//   heads and, for each, the query tiles (BQ2 = 32 rows) from the first
//   that sees the tile's first key, so tiles wholly above the causal
//   diagonal are never read. A thread owns 4 keys x 2 queries of each
//   score tile and 4 keys x D / 16 columns of both accumulators; dK and
//   dV are summed over the group in registers and written once.
// S and dP are recomputed in both kernels (seven products instead of
// five). P and dS stay float32 for the dV, dK and dQ products (the TPU
// kernel rounds them to the input type first); every product runs on the
// CUDA cores in float32, far below the tensor-core rate. The planned
// redesign stages tiles with TMA and runs the products on wgmma.
#include "common.cuh"
#include "flash_mask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int LANES = 16;                         // threads of one row group
constexpr int GROUPS = kThreads / LANES;          // 16 row groups
// dQ kernel
constexpr int RPT = 4;                            // query rows per thread
constexpr int KPT = 2;                            // keys per thread
constexpr int BQ = GROUPS * RPT;                  // 64 queries per block
constexpr int BK = LANES * KPT;                   // 32 keys per tile
// dK/dV kernel
constexpr int KRT = 4;                            // keys per thread
constexpr int QPT = 2;                            // queries per thread
constexpr int BKV = GROUPS * KRT;                 // 64 keys per block
constexpr int BQ2 = LANES * QPT;                  // 32 queries per tile

using ptt::Bounds;
using ptt::bound_row;
using ptt::range_visible;
using ptt::stage_bounds;

// Stages rows [r0, r0 + n) of a [S, heads, D] tensor (one head) into a
// float32 [n, DP] tile, zeros past S.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      int S, int64_t stride, int D, int DP) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int p = r0 + r;
    dst[r * DP + d] = p < S ? ptt::to_f(src[p * stride + d]) : 0.f;
  }
}

// NJ: accumulator columns per lane, at least ceil(D / 16); NM: masked
// row intervals per key (0: no range mask)
template <typename T, int NJ, int NM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Bounds mb, int Sq, int Sk, int H, int Hkv, int D,
                    float scale, int causal) {
  extern __shared__ float sm[];
  const int DP = D + 1;                  // padded stride: no bank conflicts
  float* q_s = sm;                       // [BQ, DP]
  float* do_s = q_s + BQ * DP;           // [BQ, DP]
  float* k_s = do_s + BQ * DP;           // [BK, DP]
  float* v_s = k_s + BK * DP;            // [BK, DP]
  float* ds_s = v_s + BK * DP;           // [BQ, BK + 1]
  float* lse_s = ds_s + BQ * (BK + 1);   // [BQ]
  float* dl_s = lse_s + BQ;              // [BQ]
  int* b_s = (int*)(dl_s + BQ);          // [2 * NM, BK] bounds

  const int tid = threadIdx.x;
  const int rg = tid / LANES, lane = tid % LANES;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int off = Sk - Sq;               // bottom-right causal offset

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* dob = dout + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Sk * Hkv + g) * D;
  const T* vb = v + ((int64_t)b * Sk * Hkv + g) * D;
  T* dqb = dq + ((int64_t)b * Sq * H + h) * D;
  const int64_t mrow = NM ? bound_row(mb, b, h, g, H, Sk) : 0;

  stage(q_s, qb, q0, BQ, Sq, q_stride, D, DP);
  stage(do_s, dob, q0, BQ, Sq, q_stride, D, DP);
  for (int r = tid; r < BQ; r += kThreads) {
    const int qi = q0 + r;
    lse_s[r] = qi < Sq ? lse[(int64_t)bh * Sq + qi] : 0.f;
    dl_s[r] = qi < Sq ? delta[(int64_t)bh * Sq + qi] : 0.f;
  }

  // keys the tile's last real query can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                     // staging done; last tile's reads done
    stage(k_s, kb, k0, BK, Sk, kv_stride, D, DP);
    stage(v_s, vb, k0, BK, Sk, kv_stride, D, DP);
    if (NM) stage_bounds<NM>(b_s, mb, mrow, k0, BK, Sk);
    __syncthreads();

    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[KPT], vv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = q_s[(rg * RPT + i) * DP + d];
        ov[i] = do_s[(rg * RPT + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        kv[j] = k_s[(lane + j * LANES) * DP + d];
        vv[j] = v_s[(lane + j * LANES) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + lane + j * LANES;
        const bool ok = qi < Sq && kp < Sk && (!causal || qi + off >= kp) &&
                        range_visible<NM>(b_s, BK, lane + j * LANES, qi);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * (BK + 1) + lane + j * LANES] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    const int t_end = min(BK, k_end - k0);
    for (int t = 0; t < t_end; ++t) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ds_s[(rg * RPT + i) * (BK + 1) + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + j * LANES;
        if (d < D) {
          const float kk = k_s[t * DP + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] += dsv[i] * kk;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + j * LANES;
      if (d < D) dqb[qi * q_stride + d] = ptt::from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int NJ, int NM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Bounds mb, int Sq, int Sk, int H,
                     int Hkv, int D, float scale, int causal) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* k_s = sm;                       // [BKV, DP]
  float* v_s = k_s + BKV * DP;           // [BKV, DP]
  float* q_s = v_s + BKV * DP;           // [BQ2, DP]
  float* do_s = q_s + BQ2 * DP;          // [BQ2, DP]
  float* p_s = do_s + BQ2 * DP;          // [BKV, BQ2 + 1]
  float* ds_s = p_s + BKV * (BQ2 + 1);   // [BKV, BQ2 + 1]
  float* lse_s = ds_s + BKV * (BQ2 + 1); // [BQ2]
  float* dl_s = lse_s + BQ2;             // [BQ2]
  int* b_s = (int*)(dl_s + BQ2);         // [2 * NM, BKV] bounds

  const int tid = threadIdx.x;
  const int rg = tid / LANES, lane = tid % LANES;
  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * BKV;       // low tiles see the most queries
  const int off = Sk - Sq;

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* kb = k + ((int64_t)b * Sk * Hkv + g) * D;
  const T* vb = v + ((int64_t)b * Sk * Hkv + g) * D;
  stage(k_s, kb, k0, BKV, Sk, kv_stride, D, DP);
  stage(v_s, vb, k0, BKV, Sk, kv_stride, D, DP);

  // the first query that sees key k0, rounded down to its tile
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt0 = (q_first / BQ2) * BQ2;

  float dk_acc[KRT][NJ], dv_acc[KRT][NJ];
#pragma unroll
  for (int i = 0; i < KRT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t bh = (int64_t)b * H + h;
    const T* qb = q + ((int64_t)b * Sq * H + h) * D;
    const T* dob = dout + ((int64_t)b * Sq * H + h) * D;
    if (NM && (r == 0 || mb.kh == H)) {
      // the tile's bounds for this head: the row changes with the head
      // only when kh = H; the last head's reads ended at a sync
      __syncthreads();
      stage_bounds<NM>(b_s, mb, bound_row(mb, b, h, g, H, Sk), k0, BKV, Sk);
    }
    for (int q0 = qt0; q0 < Sq; q0 += BQ2) {
      __syncthreads();                   // last tile's reads done
      stage(q_s, qb, q0, BQ2, Sq, q_stride, D, DP);
      stage(do_s, dob, q0, BQ2, Sq, q_stride, D, DP);
      for (int t = tid; t < BQ2; t += kThreads) {
        const int qi = q0 + t;
        lse_s[t] = qi < Sq ? lse[bh * Sq + qi] : 0.f;
        dl_s[t] = qi < Sq ? delta[bh * Sq + qi] : 0.f;
      }
      __syncthreads();

      float s[KRT][QPT], dp[KRT][QPT];
#pragma unroll
      for (int i = 0; i < KRT; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[KRT], vv[KRT], qv[QPT], ov[QPT];
#pragma unroll
        for (int i = 0; i < KRT; ++i) {
          kv[i] = k_s[(rg * KRT + i) * DP + d];
          vv[i] = v_s[(rg * KRT + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          qv[j] = q_s[(lane + j * LANES) * DP + d];
          ov[j] = do_s[(lane + j * LANES) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < KRT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            s[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * ov[j];
          }
      }

#pragma unroll
      for (int i = 0; i < KRT; ++i) {
        const int kr = rg * KRT + i;
        const int kp = k0 + kr;
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const int t = lane + j * LANES;
          const int qi = q0 + t;
          // padded query rows add nothing to dK / dV
          const bool ok = qi < Sq && kp < Sk && (!causal || qi + off >= kp) &&
                          range_visible<NM>(b_s, BKV, kr, qi);
          const float p = ok ? expf(s[i][j] * scale - lse_s[t]) : 0.f;
          p_s[kr * (BQ2 + 1) + t] = p;
          ds_s[kr * (BQ2 + 1) + t] = p * (dp[i][j] - dl_s[t]);
        }
      }
      __syncthreads();

      const int t_end = min(BQ2, Sq - q0);
      for (int t = 0; t < t_end; ++t) {
        float pv[KRT], dsv[KRT];
#pragma unroll
        for (int i = 0; i < KRT; ++i) {
          pv[i] = p_s[(rg * KRT + i) * (BQ2 + 1) + t];
          dsv[i] = ds_s[(rg * KRT + i) * (BQ2 + 1) + t];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + j * LANES;
          if (d < D) {
            const float o = do_s[t * DP + d];
            const float qq = q_s[t * DP + d];
#pragma unroll
            for (int i = 0; i < KRT; ++i) {
              dv_acc[i][j] += pv[i] * o;
              dk_acc[i][j] += dsv[i] * qq;
            }
          }
        }
      }
    }
  }

  T* dkb = dk + ((int64_t)b * Sk * Hkv + g) * D;
  T* dvb = dv + ((int64_t)b * Sk * Hkv + g) * D;
#pragma unroll
  for (int i = 0; i < KRT; ++i) {
    const int kp = k0 + rg * KRT + i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + j * LANES;
      if (d < D) {
        dkb[kp * kv_stride + d] = ptt::from_f<T>(dk_acc[i][j] * scale);
        dvb[kp * kv_stride + d] = ptt::from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NJ, int NM>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const Bounds& mb, int B, int Sq, int Sk, int H, int Hkv, int D,
           float scale, int causal, cudaStream_t s) {
  const size_t dp = (size_t)D + 1;
  const size_t smem_q = sizeof(float) *
      (2 * BQ * dp + 2 * BK * dp + (size_t)BQ * (BK + 1) + 2 * BQ) +
      sizeof(int) * 2 * NM * BK;
  const size_t smem_kv = sizeof(float) *
      (2 * BKV * dp + 2 * BQ2 * dp + 2 * (size_t)BKV * (BQ2 + 1) + 2 * BQ2) +
      sizeof(int) * 2 * NM * BKV;
  auto kq = flash_bwd_dq_kernel<T, NJ, NM>;
  auto kkv = flash_bwd_dkv_kernel<T, NJ, NM>;
  int e = allow_smem(kq, smem_q);
  if (e) return e;
  e = allow_smem(kkv, smem_kv);
  if (e) return e;
  dim3 grid_q((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kq<<<grid_q, kThreads, smem_q, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, mb, Sq, Sk, H, Hkv, D, scale, causal);
  e = (int)cudaGetLastError();
  if (e || Sk == 0) return e;
  dim3 grid_kv((unsigned)(B * Hkv), (unsigned)((Sk + BKV - 1) / BKV));
  kkv<<<grid_kv, kThreads, smem_kv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, mb, Sq, Sk, H, Hkv, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NM>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, const Bounds& mb, int B, int Sq, int Sk, int H,
             int Hkv, int D, float scale, int causal, cudaStream_t s) {
#define PTT_BWD(NJ) return launch<T, NJ, NM>(q, k, v, dout, lse, delta, dq, \
    dk, dv, mb, B, Sq, Sk, H, Hkv, D, scale, causal, s)
  if (D <= 16) PTT_BWD(1);
  if (D <= 32) PTT_BWD(2);
  if (D <= 64) PTT_BWD(4);
  if (D <= 128) PTT_BWD(8);
  PTT_BWD(16);
#undef PTT_BWD
}

int bwd_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, int D, float scale, int causal, int dtype,
              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D % 8 != 0 || D > 256 ||
      (long long)B * H > 0x7fffffffLL || (Sq + BQ - 1) / BQ > 65535 ||
      (Sk + BKV - 1) / BKV > 65535 || !ptt::bounds_ok(mb, nm, H, Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  PTT_DISPATCH(dtype, T,
    if (nm == 0)
      return launch_d<T, 0>(q, k, v, dout, l, dl, dq, dk, dv, mb, B, Sq, Sk,
                            H, Hkv, D, scale, causal, s);
    if (nm == 1)
      return launch_d<T, 1>(q, k, v, dout, l, dl, dq, dk, dv, mb, B, Sq, Sk,
                            H, Hkv, D, scale, causal, s);
    return launch_d<T, 2>(q, k, v, dout, l, dl, dq, dk, dv, mb, B, Sq, Sk, H,
                          Hkv, D, scale, causal, s))
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int B,
                                       int Sq, int Sk, int H, int Hkv, int D,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  const Bounds none = {nullptr, nullptr, nullptr, nullptr, 1};
  return bwd_entry(q, k, v, dout, lse, delta, dq, dk, dv, none, 0, B, Sq, Sk,
                   H, Hkv, D, scale, causal, dtype, stream);
}

// start/end (and start2/end2 when nm == 2): [B, kh, Sk] int32
extern "C" int ptt_flashmask_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D,
    float scale, int causal, int dtype, void* stream) {
  const Bounds mb = {(const int*)start, (const int*)end, (const int*)start2,
                     (const int*)end2, kh};
  return bwd_entry(q, k, v, dout, lse, delta, dq, dk, dv, mb, nm, B, Sq, Sk,
                   H, Hkv, D, scale, causal, dtype, stream);
}
