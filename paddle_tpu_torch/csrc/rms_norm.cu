// Row RMSNorm, forward: out = (x * rsqrt(mean(x^2) + eps) * w) in float32,
// cast once to x's type.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/norms.py:_rms_kernel
// (rms_norm_pallas). What bounds it on the H100: memory. It reads each row
// and the weight and writes the row once, a few operations per element, so
// the floor is (2 * rows * H + H) elements over 3.35 TB/s. The weight
// multiply happens in float32 before the single cast, as in the Pallas
// kernel: moving it after the cast changes bf16 results by about one ulp.
//
// Design (the vector path): each row is read from device memory once, in
// 16-byte vectors (8 bf16/f16 values, 4 float32), and stays in registers
// between the sum of squares and the scaling; the output is written in the
// same vectors. wpr warps share a row (one warp for a row of up to 256
// vectors, 2048 bf16 values; up to 8 warps, whose partial sums meet in one
// shared-memory step); a block of 8 warps takes 8 / wpr rows at a time and
// walks the rows in a grid-stride loop over as many blocks as the card
// holds at once, so each thread loads its slice of the weight once, in
// vectors, and reuses it for every row it scales. Short batches (the decode
// step's 4 rows) raise wpr to spread a row's loads over more SMs. Rows of a
// width that is no whole number of vectors, pointers not aligned to them,
// or rows too wide for the registers take the scalar path: one block per
// row, a strided first pass for the sum of squares and a second that reads
// the row again (from L1/L2) to scale it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;      // vectors a lane holds in registers

template <typename T, typename W>
__global__ void rms_norm_rows_kernel(const T* __restrict__ x,
                                     const W* __restrict__ w,
                                     T* __restrict__ out, int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = out + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float v = ptt::to_f(xr[i]);
    ss += v * v;
  }
  __shared__ float part[kWarps];
  __shared__ float rstd;
  ss = ptt::warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    float t = lane < nw ? part[lane] : 0.f;
    t = ptt::warp_sum(t);
    if (lane == 0) rstd = rsqrtf(t / (float)h + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float y = ptt::to_f(xr[i]) * r;
    orow[i] = ptt::from_f<T>(y * ptt::to_f(w[i]));
  }
}

template <typename T, typename W, int NPL>
__global__ void __launch_bounds__(kThreads) rms_norm_vec_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    long long rows, int h, int wpr, float eps) {
  constexpr int VE = 16 / sizeof(T);      // elements of a 16-byte vector
  const int nvec = h / VE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = kWarps / wpr;           // rows a block takes at a time
  const int rl = warp / wpr;              // this warp's row of them
  const int tr = (warp - rl * wpr) * 32 + lane;
  const int stride = wpr * 32;            // threads on a row
  ptt::Vec<W, VE> wv[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int v = tr + j * stride;
    if (v < nvec) wv[j].load(w + (int64_t)v * VE);
  }
  __shared__ float part[2][kWarps];       // by iteration parity
  int par = 0;
  for (long long base = (long long)blockIdx.x * rpb; base < rows;
       base += (long long)gridDim.x * rpb, par ^= 1) {
    const long long row = base + rl;
    const bool live = row < rows;
    ptt::Vec<T, VE> xv[NPL];
    float ss = 0.f;
    if (live) {
      const T* xr = x + row * h;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = tr + j * stride;
        if (v < nvec) xv[j].load(xr + (int64_t)v * VE);
      }
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        if (tr + j * stride < nvec) {
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const float f = xv[j].get(e);
            ss += f * f;
          }
        }
      }
    }
    ss = ptt::warp_sum(ss);
    if (wpr > 1) {                        // uniform across the block
      if (lane == 0) part[par][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < wpr; ++i) ss += part[par][rl * wpr + i];
    }
    if (live) {
      const float r = rsqrtf(ss / (float)h + eps);
      T* orow = out + row * h;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = tr + j * stride;
        if (v < nvec) {
          ptt::Vec<T, VE> o;
#pragma unroll
          for (int e = 0; e < VE; ++e)
            o.set(e, ptt::from_f<T>(xv[j].get(e) * r * wv[j].get(e)));
          o.store(orow + (int64_t)v * VE);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 1;
  }
  return n;
}

template <typename T, typename W, int NPL>
int launch_vec(const T* x, const W* w, T* out, long long rows, int h,
               int wpr, float eps, cudaStream_t s) {
  static int per_sm = 0;                  // blocks an SM holds at once
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rms_norm_vec_kernel<T, W, NPL>, kThreads, 0) !=
            cudaSuccess || per_sm <= 0)
      per_sm = 1;
  }
  const int rpb = kWarps / wpr;
  long long blocks = (rows + rpb - 1) / rpb;
  const long long resident = (long long)per_sm * sm_count();
  if (blocks > resident) blocks = resident;
  rms_norm_vec_kernel<T, W, NPL><<<(unsigned)blocks, kThreads, 0, s>>>(
      x, w, out, rows, h, wpr, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_rms(const void* xp, const void* wp, void* outp, long long rows,
               int h, float eps, cudaStream_t s) {
  const T* x = (const T*)xp;
  const W* w = (const W*)wp;
  T* out = (T*)outp;
  constexpr int VE = 16 / sizeof(T);
  constexpr uintptr_t W_ALIGN = VE * sizeof(W) >= 16 ? 16 : VE * sizeof(W);
  const int nvec = h / VE;
  const bool vec = h % VE == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0 &&
                   ((uintptr_t)w % W_ALIGN) == 0 &&
                   nvec <= kWarps * 32 * kMaxPerLane;
  if (!vec) {
    const int threads = h >= kThreads ? kThreads : ((h + 31) / 32) * 32;
    rms_norm_rows_kernel<T, W><<<(unsigned)rows, threads, 0, s>>>(
        x, w, out, h, eps);
    return (int)cudaGetLastError();
  }
  int wpr = 1;                            // fewest warps that hold the row
  while (wpr < kWarps && nvec > wpr * 32 * kMaxPerLane) wpr *= 2;
  // a short batch: more warps a row, so that more SMs share its loads
  while (wpr < kWarps && nvec >= wpr * 2 * 32 &&
         (rows + kWarps / wpr - 1) / (kWarps / wpr) < sm_count())
    wpr *= 2;
  const int per_lane = (nvec + wpr * 32 - 1) / (wpr * 32);
  if (per_lane <= 1)
    return launch_vec<T, W, 1>(x, w, out, rows, h, wpr, eps, s);
  if (per_lane <= 2)
    return launch_vec<T, W, 2>(x, w, out, rows, h, wpr, eps, s);
  if (per_lane <= 4)
    return launch_vec<T, W, 4>(x, w, out, rows, h, wpr, eps, s);
  return launch_vec<T, W, 8>(x, w, out, rows, h, wpr, eps, s);
}

}  // namespace

extern "C" int ptt_rms_norm(const void* x, const void* w, void* out,
                            long long rows, int h, float eps, int x_dtype,
                            int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (h <= 0) return (int)cudaErrorInvalidValue;
  int rc = 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(x_dtype, T,
    PTT_DISPATCH(w_dtype, W,
      rc = launch_rms<T, W>(x, w, out, rows, h, eps, s)))
  return rc;
}
