// Rotate-half rotary position embedding (RoPE), forward:
//
//   out[..., :D/2] = x1 * cos[s, :D/2] + (-x2) * sin[s, :D/2]
//   out[..., D/2:] = x2 * cos[s, D/2:] +   x1  * sin[s, D/2:]
//
// with x [B, S, H, D] (x1, x2 its halves) and cos/sin [S, D], broadcast
// over B and H. The tables are cast to x's type first, and each product and
// the sum round to x's type, as the JAX kernel computes in x's type: in
// bfloat16 a product of two bf16 values is exact in float32, so rounding it
// once gives the bf16 product, and the result equals PyTorch's
// `x * cos + rot * sin` on bf16 tensors bit for bit. __fmul_rn/__fadd_rn
// keep nvcc from contracting the two into an FMA, which would round once
// instead of three times.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/norms.py: fused_rope_pallas.
// What bounds it on the H100: memory (x read once, out written once, the
// [S, D] tables from L2; three operations per element). Design: one pass,
// one thread per V positions of the first half of a (b, s, h) row and the V
// matching positions of the second half. The tables are read at the row's
// sequence position, never materialised to x's shape. V is 16 bytes of x
// (8 bf16 values, 4 float32) when x and out are 16-byte aligned and V
// divides D / 2, and 1 otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// float -> x's type -> float: the rounding of one operation in x's type
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return ptt::to_f(ptt::from_f<T>(x));
}

template <typename T, typename C, int V>
__global__ void rope_kernel(const T* __restrict__ x, const C* __restrict__ cos,
                            const C* __restrict__ sin, T* __restrict__ out,
                            long long n_work, int S, int H, int D) {
  const int half = D / 2;
  const int per_row = half / V;
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       w < n_work; w += (long long)gridDim.x * blockDim.x) {
    const long long row = w / per_row;          // flat (b, s, h)
    const int d0 = (int)(w % per_row) * V;
    const int s = (int)((row / H) % S);
    const T* xr = x + row * D;
    T* orow = out + row * D;
    const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(xr + d0);
    const Vec<T, V> b = *reinterpret_cast<const Vec<T, V>*>(xr + half + d0);
    const C* cr = cos + (long long)s * D;
    const C* sr = sin + (long long)s * D;
    Vec<T, V> o1, o2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int d = d0 + i;
      const float x1 = ptt::to_f(a.v[i]), x2 = ptt::to_f(b.v[i]);
      const float c1 = rnd<T>(ptt::to_f(cr[d])), s1 = rnd<T>(ptt::to_f(sr[d]));
      const float c2 = rnd<T>(ptt::to_f(cr[d + half]));
      const float s2 = rnd<T>(ptt::to_f(sr[d + half]));
      o1.v[i] = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(x1, c1)),
                                         rnd<T>(__fmul_rn(-x2, s1))));
      o2.v[i] = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(x2, c2)),
                                         rnd<T>(__fmul_rn(x1, s2))));
    }
    *reinterpret_cast<Vec<T, V>*>(orow + d0) = o1;
    *reinterpret_cast<Vec<T, V>*>(orow + half + d0) = o2;
  }
}

template <typename T, typename C, int V>
int launch(const void* x, const void* cos, const void* sin, void* out,
           long long rows, int S, int H, int D, cudaStream_t s) {
  const long long n_work = rows * (D / 2 / V);
  long long blocks = (n_work + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;             // grid-stride beyond
  rope_kernel<T, C, V><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)x, (const C*)cos, (const C*)sin, (T*)out, n_work, S, H, D);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int launch_v(const void* x, const void* cos, const void* sin, void* out,
             long long rows, int S, int H, int D, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && (D / 2) % V == 0)
    return launch<T, C, V>(x, cos, sin, out, rows, S, H, D, s);
  return launch<T, C, 1>(x, cos, sin, out, rows, S, H, D, s);
}

}  // namespace

extern "C" int ptt_fused_rope(const void* x, const void* cos, const void* sin,
                              void* out, long long rows, int S, int H, int D,
                              int x_dtype, int table_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (S <= 0 || H <= 0 || D <= 0 || D % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(x_dtype, T,
    PTT_DISPATCH(table_dtype, C,
      return launch_v<T, C>(x, cos, sin, out, rows, S, H, D, s)))
  return (int)cudaErrorInvalidValue;
}
