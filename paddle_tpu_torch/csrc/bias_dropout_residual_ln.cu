// Bias + dropout + residual + LayerNorm ("bdrln"), forward, over rows of h:
//
//   y   = residual + dropout(x + bias)                       (float32)
//   out = (y - mean(y)) * rsqrt(var(y) + eps) * w + b,  cast to x's type
//
// and it writes out, y (in x's type) and, when p > 0, the keep mask
// (uint8, 1 = kept), the residuals of the backward. x, residual, out, y
// [rows, h] in one storage type; bias, w, b [h] in one (possibly other)
// type; bias may be absent.
//
// Dropout: keep = u >= p with u = (bits >> 8) * 2^-24, and a kept value is
// multiplied by 1 / (1 - p) (passed in float32, as the TPU kernel
// multiplies by that constant). bits is a 32-bit word of Philox4x32-10
// with key (seed, 0): the element at flat index e = row * h + col takes
// word e % 4 of the block whose 64-bit counter is (e / 4, 0), low word
// first. The mask depends on (seed, e) alone, not on the launch geometry,
// so the plain PyTorch version (ops/kernels/bias_dropout_residual_ln.py)
// computes the same mask bit for bit. y is rounded as the plain version
// rounds it: x + bias, times keep, times 1 / (1 - p), plus residual, each
// a float32 operation of its own (no contraction into FMAs).
// The variance is the mean of squared deviations (two passes over y, as
// the TPU kernel computes it), not E[y^2] - mean^2.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ffn.py:
// bias_dropout_residual_ln_pallas (pallas_call at :153, body _bdrln_kernel;
// pltpu.prng_random_bits becomes Philox). What bounds it on the H100:
// memory. Per element it reads x and residual and writes out, y and the
// mask byte, a few tens of operations (Philox's 10 rounds serve 4
// elements), so the floor is those bytes over 3.35 TB/s.
//
// Design (first version): one warp per row, 8 rows per block of 256
// threads. A lane takes 8 consecutive elements at a time (16-byte loads of
// bf16) when h % 8 == 0 and every pointer is 16-byte aligned, else one at
// a time. Pass 1 computes y, writes y and the mask and sums y; pass 2 sums
// the squared deviations; pass 3 writes out. When 8 rows of float32 y fit
// in 48 KB of shared memory (h <= 1536) passes 2 and 3 read y from there;
// for wider rows they recompute it from x, bias, residual and the same
// Philox bits, which gives the same float32 y.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCachedH = 48 * 1024 / (kWarps * 4);   // 1536 floats a row

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32)
constexpr uint32_t PH_M0 = 0xD2511F53u, PH_M1 = 0xCD9E8D57u;
constexpr uint32_t PH_W0 = 0x9E3779B9u, PH_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint64_t ctr, uint32_t k0) {
  uint4 c = make_uint4((uint32_t)ctr, (uint32_t)(ctr >> 32), 0u, 0u);
  uint32_t k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PH_M0, c.x), lo0 = PH_M0 * c.x;
    const uint32_t hi1 = __umulhi(PH_M1, c.z), lo1 = PH_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PH_W0;
    k1 += PH_W1;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// V values starting at p, as float32 (V = 8: one 16-byte load for 2-byte
// types, two for float32; V = 1: one scalar)
template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float* o) {
  if constexpr (V == 8 && sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = ptt::to_f(e[j]);
  } else if constexpr (V == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = ptt::to_f(p[j]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (V == 8 && sizeof(T) == 2) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = ptt::from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = ptt::from_f<T>(v[j]);
  }
}

struct Args {
  int64_t rows;
  int h;
  float eps, p, inv_keep;
  uint32_t seed;
};

// y of the V elements at flat index e (column c) into yv; the keep bits
// into kb when p > 0.
template <int V, typename T, typename W>
__device__ __forceinline__ void make_y(const T* x, const W* bias,
                                       const T* res, int64_t e, int c,
                                       const Args& a, float* yv,
                                       uint8_t* kb) {
  float xv[V], rv[V];
  load<V>(x + e, xv);
  load<V>(res + e, rv);
  if (bias != nullptr) {
    float bv[V];
    load<V>(bias + c, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) xv[j] = __fadd_rn(xv[j], bv[j]);
  }
  if (a.p > 0.f) {
    uint32_t bits[V];
    if constexpr (V == 8) {              // e % 8 == 0: two whole blocks
      const uint4 r0 = philox((uint64_t)e >> 2, a.seed);
      const uint4 r1 = philox(((uint64_t)e >> 2) + 1, a.seed);
      bits[0] = r0.x; bits[1] = r0.y; bits[2] = r0.z; bits[3] = r0.w;
      bits[4] = r1.x; bits[5] = r1.y; bits[6] = r1.z; bits[7] = r1.w;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        bits[j] = word(philox((uint64_t)(e + j) >> 2, a.seed),
                       (int)((e + j) & 3));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float u = (float)(bits[j] >> 8) * (1.0f / 16777216.0f);
      const bool keep = u >= a.p;
      kb[j] = keep;
      xv[j] = __fmul_rn(__fmul_rn(xv[j], keep ? 1.f : 0.f), a.inv_keep);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) yv[j] = __fadd_rn(rv[j], xv[j]);
}

template <int V, typename T, typename W>
__global__ void __launch_bounds__(kThreads)
bdrln_kernel(const T* __restrict__ x, const W* __restrict__ bias,
             const T* __restrict__ res, const W* __restrict__ w,
             const W* __restrict__ bb, T* __restrict__ out,
             T* __restrict__ y_out, uint8_t* __restrict__ keep_out, Args a,
             int cached) {
  extern __shared__ float ys_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.rows) return;             // no block-wide sync below
  const int h = a.h;
  float* ys = cached ? ys_all + warp * h : nullptr;
  const int64_t base = row * h;

  float sum = 0.f;
  for (int c = lane * V; c < h; c += 32 * V) {
    float yv[V];
    uint8_t kb[V];
    make_y<V>(x, bias, res, base + c, c, a, yv, kb);
    store<V>(y_out + base + c, yv);
    if (a.p > 0.f) {
      if constexpr (V == 8) {
        uint2 m;
        uint8_t* mb = reinterpret_cast<uint8_t*>(&m);
#pragma unroll
        for (int j = 0; j < 8; ++j) mb[j] = kb[j];
        *reinterpret_cast<uint2*>(keep_out + base + c) = m;
      } else {
        keep_out[base + c] = kb[0];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (ys) ys[c + j] = yv[j];
      sum += yv[j];
    }
  }
  const float mean = ptt::warp_sum(sum) / (float)h;

  float sq = 0.f;
  for (int c = lane * V; c < h; c += 32 * V) {
    float yv[V];
    uint8_t kb[V];
    if (ys) {
#pragma unroll
      for (int j = 0; j < V; ++j) yv[j] = ys[c + j];
    } else {
      make_y<V>(x, bias, res, base + c, c, a, yv, kb);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = yv[j] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / (float)h + a.eps);

  for (int c = lane * V; c < h; c += 32 * V) {
    float yv[V], wv[V], bv[V];
    uint8_t kb[V];
    if (ys) {
#pragma unroll
      for (int j = 0; j < V; ++j) yv[j] = ys[c + j];
    } else {
      make_y<V>(x, bias, res, base + c, c, a, yv, kb);
    }
    load<V>(w + c, wv);
    load<V>(bb + c, bv);
#pragma unroll
    for (int j = 0; j < V; ++j) yv[j] = (yv[j] - mean) * rstd * wv[j] + bv[j];
    store<V>(out + base + c, yv);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* bias, const void* res, const void* w,
           const void* b, void* out, void* y, void* keep, const Args& a,
           int vec, cudaStream_t s) {
  const int cached = a.h <= kMaxCachedH;
  const size_t smem = cached ? sizeof(float) * kWarps * (size_t)a.h : 0;
  const unsigned blocks = (unsigned)((a.rows + kWarps - 1) / kWarps);
  if (vec)
    bdrln_kernel<8, T, W><<<blocks, kThreads, smem, s>>>(
        (const T*)x, (const W*)bias, (const T*)res, (const W*)w,
        (const W*)b, (T*)out, (T*)y, (uint8_t*)keep, a, cached);
  else
    bdrln_kernel<1, T, W><<<blocks, kThreads, smem, s>>>(
        (const T*)x, (const W*)bias, (const T*)res, (const W*)w,
        (const W*)b, (T*)out, (T*)y, (uint8_t*)keep, a, cached);
  return (int)cudaGetLastError();
}

}  // namespace

// x, residual, out, y: [rows, h] of x_dtype; bias (nullable), w, b: [h] of
// w_dtype; keep: [rows, h] uint8, written only when p > 0 (then non-null).
// vec = 1 takes 8 elements a lane (h % 8 == 0, pointers 16-byte aligned).
extern "C" int ptt_bias_dropout_residual_ln(
    const void* x, const void* bias, const void* residual, const void* w,
    const void* b, void* out, void* y, void* keep, long long rows, int h,
    float eps, float p, float inv_keep, unsigned int seed, int vec,
    int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (h <= 0 || (vec && h % 8 != 0) || (p > 0.f && keep == nullptr) ||
      !(p >= 0.f && p < 1.f) || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a = {(int64_t)rows, h, eps, p, inv_keep, (uint32_t)seed};
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(x_dtype, T,
    PTT_DISPATCH(w_dtype, W,
      return launch<T, W>(x, bias, residual, w, b, out, y, keep, a, vec, s)))
  return (int)cudaErrorInvalidValue;
}
