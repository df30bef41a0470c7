// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
//
// Every kernel computes in float32 and reads or writes its tensors in one of
// three storage types, named by the dtype code the Python wrapper passes
// (ops/kernels/_build.py DTYPE_CODES): 0 float32, 1 bfloat16, 2 float16.
// The attention kernels also read int8 KV pages (to_f(int8_t)).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ptt {

// -1e30, not -inf: exp(NEG_INF - NEG_INF) is exp(0) = 1 and never NaN, so a
// tile whose every score is masked leaves the running max finite (the JAX
// kernels use the same constant, ops/pallas/decode_attention.py NEG_INF).
constexpr float NEG_INF = -1e30f;
// the online-softmax finalize clamps the normalizer at this value, so a row
// that saw no visible key (query padding, an empty context) writes 0 rather
// than 0/0 (ops/primitive/tiles.py _L_EPS)
constexpr float L_EPS = 1e-30f;
// int8 KV pages hold codes in [-127, 127]; a page's values are
// code * (scale * INV_QMAX), the multiplier folded as the JAX kernels'
// _INV_QMAX (ops/pallas/quantized_attention.py)
constexpr float INV_QMAX = 1.0f / 127.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <int BYTES> struct RawWord;
template <> struct RawWord<16> { typedef uint4 type; };
template <> struct RawWord<8> { typedef uint2 type; };
template <> struct RawWord<4> { typedef unsigned type; };
template <> struct RawWord<2> { typedef unsigned short type; };
template <> struct RawWord<1> { typedef unsigned char type; };

// N consecutive elements of X held in registers as raw words and moved by
// one load or store of up to 16 bytes each (the address must be aligned to
// min(16, N * sizeof(X)) bytes); get/set read and write one element.
template <typename X, int N>
struct Vec {
  static constexpr int BYTES = N * (int)sizeof(X);
  static constexpr int WORD = BYTES >= 16 ? 16 : BYTES;
  static constexpr int WORDS = BYTES / WORD;
  typedef typename RawWord<WORD>::type word;
  word w[WORDS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = word{};
  }
  __device__ __forceinline__ void load(const X* p) {
    const word* s = reinterpret_cast<const word*>(p);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = s[i];
  }
  __device__ __forceinline__ void store(X* p) const {
    word* d = reinterpret_cast<word*>(p);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) d[i] = w[i];
  }
  __device__ __forceinline__ float get(int j) const {
    return to_f(reinterpret_cast<const X*>(w)[j]);
  }
  __device__ __forceinline__ void set(int j, X v) {
    reinterpret_cast<X*>(w)[j] = v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt

// Expands the body (the variadic part, so that it may hold commas) once per
// storage type; T names the type inside it. An unknown code returns
// cudaErrorInvalidValue from the enclosing C entry.
#define PTT_DISPATCH(code, T, ...)                               \
  switch (code) {                                                \
    case 0: { typedef float T; __VA_ARGS__; break; }             \
    case 1: { typedef __nv_bfloat16 T; __VA_ARGS__; break; }     \
    case 2: { typedef __half T; __VA_ARGS__; break; }            \
    default: return (int)cudaErrorInvalidValue;                  \
  }
