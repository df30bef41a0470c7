// Ragged paged attention: one launch for rows of different query counts
// (chunked prefill, suffix prefill after a prefix-cache hit, and decode rows
// with one query each), every row attending causally over its own paged
// context. The kernel template, shared by the float-page entry
// (ragged_attention.cu) and the int8-page entry (quantized_attention.cu).
//
//   q          [C, Q_max, H, D]     right-padded; row r's q_lens[r] real
//                                   queries sit at the TAIL of its context:
//                                   query i is at position ctx - q_len + i
//   k/v pages  [N, page, H_kv, D]   the layer's page pools (the batch's own
//                                   KV was written before this launch): q's
//                                   type, or int8 codes with k/v scales
//                                   [N] f32
//   block_tables [C, P], context_lens [C], q_lens [C]   int32
//   out        [C, Q_max, H, D]     padded query rows are 0
//
// Key k_pos is visible to query i when k_pos <= q_pos, k_pos < ctx and
// i < q_len. Dummy rows (q_len 1, context 1, all-trash table) are ordinary
// rows under that rule.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_attention.py:
// _ragged_kernel (ragged_paged_attention). What bounds it on the H100:
// operations for prefill rows (a 256-query chunk over a 1k context does
// ~4 * 256 * 1k * D operations per head against ~2 * 1k * D * 2 bytes of
// K and V), memory for decode rows. The floor is the larger of the causal
// operations over 989 TFLOP/s and the visible K/V bytes over 3.35 TB/s.
//
// Design (first version): one block per (row, KV head, tile of QT query
// positions); the tile's QT * rep query rows (flat j = q_idx * rep + r, as
// the Pallas kernel orders them) share each page read. A tile past the
// row's q_len writes zeros and reads nothing; the page loop stops at the
// last key the tile's last real query can see, so decode rows and early
// tiles of a prefill row read only what they need. Each page of K and V is
// staged in shared memory as float32 (K with a padded row stride, so the
// score loop's (row, key) lanes hit distinct banks), scores and the online
// softmax run in float32 on the CUDA cores, and the accumulator lives in
// shared memory. This is well below the card's tensor-core rate; the
// planned redesign stages K/V tiles with TMA and runs QK^T and PV on
// wgmma, with the accumulator in registers.
//
// int8 pages (replacing paddle_tpu/ops/pallas/quantized_attention.py:
// _ragged_int8_kernel): KV is int8 and the scale pointers are set; each
// page is dequantized as it is staged, code * (scale[pid] * (1/127)), as
// in decode_attention.cuh. Float pages pass null scales and multiply by
// 1.0f, which is exact.
#pragma once

#include "common.cuh"

namespace ptt {

template <typename T, typename KV>
__global__ void ragged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                              const KV* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ bt,
                              const int* __restrict__ cl, const int* __restrict__ ql,
                              T* __restrict__ out, int Qmax, int H, int Hkv, int D,
                              int page, int P, int QT, float scale) {
  extern __shared__ float sm[];
  const int tile = blockIdx.x;
  const int g = blockIdx.y;               // KV head
  const int64_t row = blockIdx.z;         // batch row
  const int rep = H / Hkv;
  const int R = QT * rep;                 // query rows of this tile
  const int DP = D + 1;                   // padded stride of q_s and k_s
  float* q_s = sm;                        // [R, DP]
  float* acc_s = q_s + R * DP;            // [R, D]
  float* k_s = acc_s + R * D;             // [page, DP]
  float* v_s = k_s + page * DP;           // [page, D]
  float* s_s = v_s + page * D;            // [R, page] scores, then probs
  float* m_s = s_s + R * page;            // [R]
  float* l_s = m_s + R;                   // [R]
  float* a_s = l_s + R;                   // [R]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int ctx = cl[row];
  const int q_len = ql[row];
  const int q0 = tile * QT;
  const int q_end = min(q0 + QT, Qmax);   // tile's query indices [q0, q_end)

  if (q0 >= q_len) {                      // all padding: zeros, no reads
    for (int i = tid; i < (q_end - q0) * rep * D; i += nt) {
      const int j = i / D, d = i % D;
      const int qi = q0 + j / rep, r = j % rep;
      out[((row * Qmax + qi) * H + g * rep + r) * D + d] = ptt::from_f<T>(0.f);
    }
    return;
  }

  for (int i = tid; i < R * D; i += nt) {
    const int j = i / D, d = i % D;
    const int qi = q0 + j / rep, r = j % rep;
    q_s[j * DP + d] = (qi < q_len)
        ? ptt::to_f(q[((row * Qmax + qi) * H + g * rep + r) * D + d]) : 0.f;
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < R; j += nt) {
    m_s[j] = ptt::NEG_INF;
    l_s[j] = 0.f;
  }
  __syncthreads();

  const int q_last = min(q_end, q_len) - 1;        // last real query here
  int last_key = ctx - q_len + q_last;             // causal bound
  if (last_key > ctx - 1) last_key = ctx - 1;
  int n_pages = last_key < 0 ? 0 : last_key / page + 1;
  if (n_pages > P) n_pages = P;

  for (int p = 0; p < n_pages; ++p) {
    const int64_t pid = bt[row * P + p];
    const float km = ks ? ks[pid] * INV_QMAX : 1.f;
    const float vm = vs ? vs[pid] * INV_QMAX : 1.f;
    for (int i = tid; i < page * D; i += nt) {
      const int t = i / D, d = i % D;
      const int64_t off = ((pid * page + t) * Hkv + g) * D + d;
      k_s[t * DP + d] = to_f(kp[off]) * km;
      v_s[i] = to_f(vp[off]) * vm;
    }
    __syncthreads();

    for (int i = tid; i < R * page; i += nt) {
      const int j = i / page, t = i % page;
      const int qi = q0 + j / rep;
      const int q_pos = ctx - q_len + qi;
      const int k_pos = p * page + t;
      float s = ptt::NEG_INF;
      if (qi < q_len && k_pos <= q_pos && k_pos < ctx) {
        float dot = 0.f;
        const float* qr = q_s + j * DP;
        const float* kr = k_s + t * DP;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int j = tid; j < R; j += nt) {
      const int qi = q0 + j / rep;
      const int q_pos = ctx - q_len + qi;
      const float m_old = m_s[j];
      float m_cur = ptt::NEG_INF;
      for (int t = 0; t < page; ++t) m_cur = fmaxf(m_cur, s_s[j * page + t]);
      const float m_new = fmaxf(m_old, m_cur);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const int k_pos = p * page + t;
        const bool ok = qi < q_len && k_pos <= q_pos && k_pos < ctx;
        const float e = ok ? expf(s_s[j * page + t] - m_new) : 0.f;
        s_s[j * page + t] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      a_s[j] = alpha;
      l_s[j] = alpha * l_s[j] + sum;
      m_s[j] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += nt) {
      const int j = i / D, d = i % D;
      float a = acc_s[i] * a_s[j];
      for (int t = 0; t < page; ++t) a += s_s[j * page + t] * v_s[t * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < (q_end - q0) * rep * D; i += nt) {
    const int j = i / D, d = i % D;
    const int qi = q0 + j / rep, r = j % rep;
    out[((row * Qmax + qi) * H + g * rep + r) * D + d] =
        ptt::from_f<T>(acc_s[i] / fmaxf(l_s[j], ptt::L_EPS));
  }
}

// One launch of ragged_kernel<T, KV>; returns the CUDA error code.
template <typename T, typename KV>
int launch_ragged(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scales, const float* v_scales,
                  const int* block_tables, const int* context_lens,
                  const int* q_lens, void* out, int C, int Qmax, int H,
                  int Hkv, int D, int page, int P, int QT, float scale,
                  cudaStream_t s) {
  if (C <= 0 || Qmax <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || QT <= 0) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const size_t R = (size_t)QT * rep;
  const size_t smem = sizeof(float) *
      (R * (D + 1) + R * D + (size_t)page * (D + 1) + (size_t)page * D +
       R * page + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ragged_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Qmax + QT - 1) / QT, Hkv, C);
  ragged_kernel<T, KV><<<grid, 256, smem, s>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages, k_scales, v_scales,
      block_tables, context_lens, q_lens, (T*)out, Qmax, H, Hkv, D, page, P,
      QT, scale);
  return (int)cudaGetLastError();
}

}  // namespace ptt
