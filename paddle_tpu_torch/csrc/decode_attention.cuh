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
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py:
// _decode_kernel (paged_decode_attention). What bounds it on the H100:
// memory. Each visible key and value row is read once and used by the
// rep = H / H_kv queries of its group, 4 * rep * D operations per pair of
// bf16 rows, far below the card's ~295 operations per byte; the floor is
// the context's K and V bytes over 3.35 TB/s.
//
// Design (first version): one block per (sequence, KV head). The rep
// queries of the group sit in shared memory; the block walks the
// sequence's pages up to its context length (pages at or past it are never
// read; masking inside the last page goes by position, never by page id,
// because tables are padded with the trash page 0), stages one page of K
// and V in shared memory as float32, scores it with one warp per
// (query, key) pair, and carries an online softmax (running max, normalizer
// and float32 accumulator) across pages. At decode B * H_kv is small (128
// blocks for Llama-2-7B at B = 4, 32 for a GQA model with 8 KV heads) and
// each block reads its pages one after another, so the card is far from
// its memory rate at short contexts. The planned redesign is split-K
// (flash-decoding): several blocks per (sequence, head), each over a range
// of pages, with a second pass that merges their (max, sum, accumulator).
//
// int8 pages (replacing paddle_tpu/ops/pallas/quantized_attention.py:
// _decode_int8_kernel): KV is int8 and the scale pointers are set. Each
// page is dequantized as it is staged, code * (scale[pid] * (1/127)), the
// multiplier folded as the JAX kernel's _INV_QMAX; no float pool exists.
// The bound is then the int8 context bytes, half the bf16 ones. Float
// pages pass null scales and multiply by 1.0f, which is exact: the float
// instantiation computes what it did before the template.
#pragma once

#include "common.cuh"

namespace ptt {

template <typename T, typename KV>
__global__ void decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                              const KV* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ bt,
                              const int* __restrict__ cl, T* __restrict__ out,
                              int H, int Hkv, int D, int page, int P, float scale) {
  extern __shared__ float sm[];
  const int g = blockIdx.x;               // KV head
  const int64_t b = blockIdx.y;           // sequence
  const int rep = H / Hkv;
  float* q_s = sm;                        // [rep, D]
  float* acc_s = q_s + rep * D;           // [rep, D]
  float* k_s = acc_s + rep * D;           // [page, D]
  float* v_s = k_s + page * D;            // [page, D]
  float* p_s = v_s + page * D;            // [rep, page] scores, then probs
  float* m_s = p_s + rep * page;          // [rep] running max
  float* l_s = m_s + rep;                 // [rep] running normalizer
  float* a_s = l_s + rep;                 // [rep] rescale of this page

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int ctx = cl[b];

  for (int i = tid; i < rep * D; i += nt) {
    const int r = i / D, d = i % D;
    q_s[i] = ptt::to_f(q[(b * H + g * rep + r) * D + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += nt) {
    m_s[r] = ptt::NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  int n_pages = (ctx + page - 1) / page;
  if (n_pages > P) n_pages = P;
  for (int p = 0; p < n_pages; ++p) {
    const int64_t pid = bt[b * P + p];
    const float km = ks ? ks[pid] * INV_QMAX : 1.f;
    const float vm = vs ? vs[pid] * INV_QMAX : 1.f;
    for (int i = tid; i < page * D; i += nt) {
      const int t = i / D, d = i % D;
      const int64_t off = ((pid * page + t) * Hkv + g) * D + d;
      k_s[i] = to_f(kp[off]) * km;
      v_s[i] = to_f(vp[off]) * vm;
    }
    __syncthreads();

    for (int j = warp; j < rep * page; j += nw) {
      const int r = j / page, t = j % page;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += q_s[r * D + d] * k_s[t * D + d];
      s = ptt::warp_sum(s);
      if (lane == 0) p_s[j] = (p * page + t < ctx) ? s * scale : ptt::NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < rep; r += nt) {
      const float m_old = m_s[r];
      float m_cur = ptt::NEG_INF;
      for (int t = 0; t < page; ++t) m_cur = fmaxf(m_cur, p_s[r * page + t]);
      const float m_new = fmaxf(m_old, m_cur);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float e = (p * page + t < ctx) ? expf(p_s[r * page + t] - m_new) : 0.f;
        p_s[r * page + t] = e;
        sum += e;
      }
      const float alpha = expf(m_old - m_new);
      a_s[r] = alpha;
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < rep * D; i += nt) {
      const int r = i / D, d = i % D;
      float a = acc_s[i] * a_s[r];
      for (int t = 0; t < page; ++t) a += p_s[r * page + t] * v_s[t * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rep * D; i += nt) {
    const int r = i / D, d = i % D;
    out[(b * H + g * rep + r) * D + d] =
        ptt::from_f<T>(acc_s[i] / fmaxf(l_s[r], ptt::L_EPS));
  }
}

// One launch of decode_kernel<T, KV>; returns the CUDA error code.
template <typename T, typename KV>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scales, const float* v_scales,
                  const int* block_tables, const int* context_lens, void* out,
                  int B, int H, int Hkv, int D, int page, int P, float scale,
                  cudaStream_t s) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const size_t smem =
      sizeof(float) * (2 * (size_t)rep * D + 2 * (size_t)page * D +
                       (size_t)rep * page + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<T, KV><<<dim3(Hkv, B), 128, smem, s>>>(
      (const T*)q, (const KV*)k_pages, (const KV*)v_pages, k_scales, v_scales,
      block_tables, context_lens, (T*)out, H, Hkv, D, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace ptt
