// SwiGLU, forward: out = silu(gate) * up = gate * sigmoid(gate) * up in
// float32, cast once to gate's type.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ffn.py:_swiglu_kernel
// (swiglu_pallas). What bounds it on the H100: memory. It reads two tensors
// and writes one, four operations per element, so the floor is
// 3 * n elements over 3.35 TB/s. Design: a grid-stride loop over the
// flattened tensor; when every pointer is 16-byte aligned and n is a
// multiple of the vector width, each thread moves 16 bytes per load
// (8 bf16 or 4 float32 values), otherwise one element at a time. The
// backward (fused_ffn.py:_swiglu_bwd) comes with the training slice.
#include "common.cuh"

namespace {

__device__ __forceinline__ float swiglu_f(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

template <typename T>
__global__ void swiglu_scalar(const T* __restrict__ g, const T* __restrict__ u,
                              T* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = ptt::from_f<T>(swiglu_f(ptt::to_f(g[i]), ptt::to_f(u[i])));
}

// VEC elements of T per 16-byte uint4
template <typename T>
__global__ void swiglu_vec(const uint4* __restrict__ g, const uint4* __restrict__ u,
                           uint4* __restrict__ out, int64_t nvec) {
  constexpr int VEC = 16 / sizeof(T);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nvec;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint4 gv = g[i], uv = u[i], ov;
    const T* ga = reinterpret_cast<const T*>(&gv);
    const T* ua = reinterpret_cast<const T*>(&uv);
    T* oa = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      oa[j] = ptt::from_f<T>(swiglu_f(ptt::to_f(ga[j]), ptt::to_f(ua[j])));
    out[i] = ov;
  }
}

}  // namespace

extern "C" int ptt_swiglu(const void* g, const void* u, void* out, long long n,
                          int dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const bool aligned = ((uintptr_t)g % 16 == 0) && ((uintptr_t)u % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  PTT_DISPATCH(dtype, T, {
    constexpr int VEC = 16 / sizeof(T);
    if (aligned && n % VEC == 0) {
      const int64_t nvec = n / VEC;
      int64_t blocks = (nvec + threads - 1) / threads;
      if (blocks > 132 * 16) blocks = 132 * 16;
      swiglu_vec<T><<<(unsigned)blocks, threads, 0, s>>>(
          (const uint4*)g, (const uint4*)u, (uint4*)out, nvec);
    } else {
      int64_t blocks = (n + threads - 1) / threads;
      if (blocks > 132 * 16) blocks = 132 * 16;
      swiglu_scalar<T><<<(unsigned)blocks, threads, 0, s>>>(
          (const T*)g, (const T*)u, (T*)out, n);
    }
  })
  return (int)cudaGetLastError();
}
