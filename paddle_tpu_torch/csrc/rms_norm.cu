// Row RMSNorm, forward: out = (x * rsqrt(mean(x^2) + eps) * w) in float32,
// cast once to x's type.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/norms.py:_rms_kernel
// (rms_norm_pallas). What bounds it on the H100: memory. It reads each row
// and the weight and writes the row once, a few operations per element, so
// the floor is (2 * rows * H + H) elements over 3.35 TB/s. Design: one block
// per row; each thread keeps its strided share of the row in float32
// partial sums, the block reduces them through warp shuffles and one shared
// array, and the second pass reads the row again (from L1/L2, the row is at
// most a few KB) to scale it. The weight multiply happens in float32 before
// the single cast, as in the Pallas kernel: moving it after the cast changes
// bf16 results by about one ulp.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                                T* __restrict__ out, int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = out + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float v = ptt::to_f(xr[i]);
    ss += v * v;
  }
  __shared__ float part[kThreads / 32];
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

}  // namespace

extern "C" int ptt_rms_norm(const void* x, const void* w, void* out,
                            long long rows, int h, float eps, int x_dtype,
                            int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  const int threads = h >= kThreads ? kThreads : ((h + 31) / 32) * 32;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(x_dtype, T,
    PTT_DISPATCH(w_dtype, W,
      rms_norm_kernel<T, W><<<(unsigned)rows, threads, 0, s>>>(
          (const T*)x, (const W*)w, (T*)out, h, eps)))
  return (int)cudaGetLastError();
}
