// Rotate-half rotary position embedding (RoPE) on one or two tensors in one
// launch, forward or transposed:
//
//   forward:     out = x * cos + rot(x) * sin,       rot(x1, x2)   = (-x2, x1)
//   transposed:  out = g * cos + rot^T(g * sin),     rot^T(a, b)   = (b, -a)
//
// with q [B, S, Hq, D] and an optional k [B, S, Hk, D] (GQA: k may have
// fewer heads), both rotated by the same table row. Token (b, s) reads row
// b * row_stride + s of cos/sin: row_stride 0 is the [S, D] table broadcast
// over the batch (the TPU kernel's form), row_stride S the per-token rows
// [B, S, D] that the paged steps gather at each token's own position. The
// transposed form is the vjp of the forward with respect to x (the JAX
// package's _rope_bwd). Tables (float32 or x's type) are rounded to x's
// type first, and each product and the sum round to x's type, as the JAX
// kernel computes in x's type: a product of two bf16 (or f16) values is
// exact in float32, so rounding it once gives the 16-bit product, and the
// result equals PyTorch's `x * cos + rot * sin` on bf16 tensors bit for
// bit. __fmul_rn/__fadd_rn keep nvcc from contracting a product and the sum
// into an FMA, which would round once instead of three times. In the
// transposed form the sign goes on the rounded product g * sin.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/norms.py: fused_rope_pallas
// (pallas_call :131), and serves its vjp (_rope_bwd :150) and the Llama's
// per-token rotation (paddle_tpu/models/llama.py: _rope_rows).
//
// What bounds it on the H100: memory. q and k are read once and written
// once, plus the table rows; three operations an element, nothing reused
// but the table row, which all heads of a token share. So there is no use
// for shared memory, TMA or the tensor cores here: the floor is the bytes
// over 3.35 TB/s, and what stands between a simple kernel and it is
// instruction and latency overhead per element. Design:
// - one warp per (token, slice of its heads); a lane owns one 16-byte
//   vector of the first half of a head and the matching vector of the
//   second half, so D/2 / V lanes cover a head and a warp 32 / (D/2 / V)
//   heads at a time;
// - the token's table row is loaded once, in vectors, rounded to x's type
//   once and kept in registers across all the heads the warp rotates;
// - 16-bit types compute two elements an instruction (mul/add/sub.rn on
//   bf16x2 or f16x2 words, no conversions): the float32 form's per-element
//   conversions and roundings cost as many instructions as the card
//   issues in the time its memory moves the bytes;
// - 32-bit index math inside a token, from a 64-bit base computed once a
//   token;
// - each lane issues the loads of kUnroll heads before its first store, so
//   that several 16-byte loads per lane are in flight;
// - the grid is sized from the work items and capped at the blocks the
//   card holds at once, walking the items in a stride loop; when the tokens
//   are too few to fill the card (decode, small batches) the heads of a
//   token split into slices of at least kUnroll heads per lane group.
// Head dims whose half is no whole number of vectors (or a count of
// vectors that does not divide 32), and pointers not aligned to the
// vectors, take the scalar path in the same entry: one warp per (token,
// slice), one element pair a lane, the table read per element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // heads a lane group loads before a store

struct Args {
  const void* q;
  const void* k;                  // null with hk = 0
  void* oq;
  void* ok;
  const void* cos;
  const void* sin;
  int tokens;                     // B * S
  int S, hq, hk, D, row_stride;
  int slices, per_slice;          // heads of a token split into slices
};

// float -> x's type -> float: the rounding of one operation in x's type
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return ptt::to_f(ptt::from_f<T>(x));
}

// one element pair (d, d + D/2): a = x1 (or g1), b = x2 (or g2)
template <typename T, bool BWD>
__device__ __forceinline__ void rotate(float a, float b, float c1, float c2,
                                       float s1, float s2, T& o1, T& o2) {
  if (BWD) {
    const float gs1 = rnd<T>(__fmul_rn(a, s1));
    const float gs2 = rnd<T>(__fmul_rn(b, s2));
    o1 = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(a, c1)), gs2));
    o2 = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(b, c2)), -gs1));
  } else {
    o1 = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(a, c1)),
                                  rnd<T>(__fmul_rn(-b, s1))));
    o2 = ptt::from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(b, c2)),
                                  rnd<T>(__fmul_rn(a, s2))));
  }
}

// Two 16-bit values a word: one PTX instruction of the .rn (no FMA
// contraction) form for both, rounding once. For bf16 and f16 that equals
// the float32 operation followed by one rounding to the 16-bit type, as
// rnd<T> computes it: float32 holds the exact product of two 16-bit values,
// and rounding their exact sum first to float32 and then to 16 bits is
// innocuous (24 >= 2 * 11 + 2 bits), so the two results agree bit for bit.
template <typename T> struct Packed;
template <> struct Packed<__nv_bfloat16> {
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
    unsigned d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};
template <> struct Packed<__half> {
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned d;
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
    unsigned d;
    asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// V element pairs held as vectors: float32 one element at a time
// (rotate), 16-bit types two at a time in 32-bit words (Packed): the
// first half's out = x1 c1 - x2 s1, the second's x2 c2 + x1 s2 (forward);
// g1 c1 + g2 s2 and g2 c2 - g1 s1 (transposed), each product rounded.
template <typename T, int V, bool BWD>
__device__ __forceinline__ void rotate_vec(
    const ptt::Vec<T, V>& x1, const ptt::Vec<T, V>& x2,
    const ptt::Vec<T, V>& c1, const ptt::Vec<T, V>& c2,
    const ptt::Vec<T, V>& s1, const ptt::Vec<T, V>& s2,
    ptt::Vec<T, V>& o1, ptt::Vec<T, V>& o2) {
  if constexpr (sizeof(T) == 2) {
    typedef Packed<T> P;
    const unsigned* a = reinterpret_cast<const unsigned*>(x1.w);
    const unsigned* b = reinterpret_cast<const unsigned*>(x2.w);
    const unsigned* pc1 = reinterpret_cast<const unsigned*>(c1.w);
    const unsigned* pc2 = reinterpret_cast<const unsigned*>(c2.w);
    const unsigned* ps1 = reinterpret_cast<const unsigned*>(s1.w);
    const unsigned* ps2 = reinterpret_cast<const unsigned*>(s2.w);
    unsigned* r1 = reinterpret_cast<unsigned*>(o1.w);
    unsigned* r2 = reinterpret_cast<unsigned*>(o2.w);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      if (BWD) {
        r1[i] = P::add(P::mul(a[i], pc1[i]), P::mul(b[i], ps2[i]));
        r2[i] = P::sub(P::mul(b[i], pc2[i]), P::mul(a[i], ps1[i]));
      } else {
        r1[i] = P::sub(P::mul(a[i], pc1[i]), P::mul(b[i], ps1[i]));
        r2[i] = P::add(P::mul(b[i], pc2[i]), P::mul(a[i], ps2[i]));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      T r1, r2;
      rotate<T, BWD>(x1.get(i), x2.get(i), c1.get(i), c2.get(i), s1.get(i),
                     s2.get(i), r1, r2);
      o1.set(i, r1);
      o2.set(i, r2);
    }
  }
}

// head h of the token: q's heads first, then k's
template <typename X>
__device__ __forceinline__ X* head(X* qt, X* kt, int h, int hq, int D) {
  return h < hq ? qt + h * D : kt + (h - hq) * D;
}

template <typename T, typename C, int V, bool BWD>
__global__ void __launch_bounds__(kThreads) rope_vec_kernel(Args a) {
  const int half = a.D / 2;
  const int lph = half / V;                 // lanes a head (divides 32)
  const int groups = 32 / lph;              // heads a warp takes at a time
  const int lane = threadIdx.x & 31;
  const int t = lane % lph, g = lane / lph;
  const int heads = a.hq + a.hk;
  const long long items = (long long)a.tokens * a.slices;
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < items; item += (long long)gridDim.x * kWarps) {
    const int tok = (int)(item / a.slices);
    const int h0 = (int)(item - (long long)tok * a.slices) * a.per_slice;
    const int h1 = min(h0 + a.per_slice, heads);
    const int b = tok / a.S;
    const long long row = (long long)b * a.row_stride + (tok - b * a.S);
    // the table row, rounded to x's type once
    const C* cr = (const C*)a.cos + row * a.D + t * V;
    const C* sr = (const C*)a.sin + row * a.D + t * V;
    ptt::Vec<C, V> lc1, lc2, ls1, ls2;
    lc1.load(cr);
    lc2.load(cr + half);
    ls1.load(sr);
    ls2.load(sr + half);
    ptt::Vec<T, V> c1, c2, s1, s2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      c1.set(i, ptt::from_f<T>(lc1.get(i)));
      c2.set(i, ptt::from_f<T>(lc2.get(i)));
      s1.set(i, ptt::from_f<T>(ls1.get(i)));
      s2.set(i, ptt::from_f<T>(ls2.get(i)));
    }
    const T* qt = (const T*)a.q + (size_t)tok * a.hq * a.D + t * V;
    const T* kt = (const T*)a.k + (size_t)tok * a.hk * a.D + t * V;
    T* oqt = (T*)a.oq + (size_t)tok * a.hq * a.D + t * V;
    T* okt = (T*)a.ok + (size_t)tok * a.hk * a.D + t * V;
    for (int hb = h0 + g; hb < h1; hb += groups * kUnroll) {
      ptt::Vec<T, V> x1[kUnroll], x2[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int h = hb + u * groups;
        if (h < h1) {
          const T* src = head(qt, kt, h, a.hq, a.D);
          x1[u].load(src);
          x2[u].load(src + half);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int h = hb + u * groups;
        if (h < h1) {
          ptt::Vec<T, V> o1, o2;
          rotate_vec<T, V, BWD>(x1[u], x2[u], c1, c2, s1, s2, o1, o2);
          T* dst = head(oqt, okt, h, a.hq, a.D);
          o1.store(dst);
          o2.store(dst + half);
        }
      }
    }
  }
}

template <typename T, typename C, bool BWD>
__global__ void __launch_bounds__(kThreads) rope_scalar_kernel(Args a) {
  const int half = a.D / 2;
  const int lane = threadIdx.x & 31;
  const int heads = a.hq + a.hk;
  const long long items = (long long)a.tokens * a.slices;
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       item < items; item += (long long)gridDim.x * kWarps) {
    const int tok = (int)(item / a.slices);
    const int h0 = (int)(item - (long long)tok * a.slices) * a.per_slice;
    const int h1 = min(h0 + a.per_slice, heads);
    const int b = tok / a.S;
    const long long row = (long long)b * a.row_stride + (tok - b * a.S);
    const C* cr = (const C*)a.cos + row * a.D;
    const C* sr = (const C*)a.sin + row * a.D;
    const T* qt = (const T*)a.q + (size_t)tok * a.hq * a.D;
    const T* kt = (const T*)a.k + (size_t)tok * a.hk * a.D;
    T* oqt = (T*)a.oq + (size_t)tok * a.hq * a.D;
    T* okt = (T*)a.ok + (size_t)tok * a.hk * a.D;
    for (int i = lane; i < (h1 - h0) * half; i += 32) {
      const int h = h0 + i / half, d = i % half;
      const T* src = head(qt, kt, h, a.hq, a.D);
      T* dst = head(oqt, okt, h, a.hq, a.D);
      T r1, r2;
      rotate<T, BWD>(ptt::to_f(src[d]), ptt::to_f(src[d + half]),
                     rnd<T>(ptt::to_f(cr[d])), rnd<T>(ptt::to_f(cr[d + half])),
                     rnd<T>(ptt::to_f(sr[d])), rnd<T>(ptt::to_f(sr[d + half])),
                     r1, r2);
      dst[d] = r1;
      dst[d + half] = r2;
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

// blocks of `kernel` an SM holds at once
template <typename K>
int per_sm(K kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0)
          != cudaSuccess || n <= 0)
    n = 1;
  return n;
}

// Slices a token's heads so that the items fill the card's resident warps
// where the tokens alone do not, each slice at least `min_heads` heads (a
// multiple of `groups`); then launches one wave of blocks at most.
template <typename K>
int launch(K kernel, int resident_blocks, Args a, int groups, int min_heads,
           cudaStream_t s) {
  const int heads = a.hq + a.hk;
  const long long warps = (long long)resident_blocks * kWarps;
  int slices = 1;
  while ((long long)a.tokens * slices * 2 <= warps &&
         (heads + slices * 2 - 1) / (slices * 2) >= min_heads)
    slices *= 2;
  int per = (heads + slices - 1) / slices;
  per = (per + groups - 1) / groups * groups;
  a.per_slice = per;
  a.slices = (heads + per - 1) / per;
  long long blocks = ((long long)a.tokens * a.slices + kWarps - 1) / kWarps;
  if (blocks > resident_blocks) blocks = resident_blocks;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The vector path's conditions (see the note at the top), for x elements
// of x_size bytes and table elements of c_size: 16-byte vectors of x that
// split D / 2 into a count of lanes dividing 32, x's pointers aligned to
// 16 bytes and the tables' to a vector of them.
bool vector_path(const Args& a, int x_size, int c_size) {
  const int V = 16 / x_size, half = a.D / 2, lph = half / V;
  const uintptr_t c_align = V * c_size >= 16 ? 16 : V * c_size;
  return (uintptr_t)a.q % 16 == 0 && (uintptr_t)a.oq % 16 == 0 &&
         (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.ok % 16 == 0 &&
         (uintptr_t)a.cos % c_align == 0 && (uintptr_t)a.sin % c_align == 0 &&
         half % V == 0 && lph >= 1 && lph <= 32 && 32 % lph == 0;
}

template <typename T, typename C, bool BWD>
int launch_rope(const Args& a, int* vector, cudaStream_t s) {
  *vector = vector_path(a, sizeof(T), sizeof(C));
  if (*vector) {
    constexpr int V = 16 / sizeof(T);
    static const int resident = per_sm(rope_vec_kernel<T, C, V, BWD>) *
                                sm_count();
    const int groups = 32 / (a.D / 2 / V);
    return launch(rope_vec_kernel<T, C, V, BWD>, resident, a, groups,
                  groups * kUnroll, s);
  }
  static const int resident = per_sm(rope_scalar_kernel<T, C, BWD>) *
                              sm_count();
  return launch(rope_scalar_kernel<T, C, BWD>, resident, a, 1, kUnroll, s);
}

}  // namespace

// q [tokens / S, S, hq, D] and k [.., hk, D] (k, ok null with hk = 0) into
// oq, ok; cos/sin rows b * row_stride + s; transpose 1: the vjp form.
// *vector is set to 1 when the launch took the vector path, 0 when it took
// the scalar one.
extern "C" int ptt_rope(const void* q, const void* k, void* oq, void* ok,
                        const void* cos, const void* sin, long long tokens,
                        int S, int hq, int hk, int D, int row_stride,
                        int transpose, int x_dtype, int table_dtype,
                        int* vector, void* stream) {
  *vector = 0;
  if (tokens <= 0) return 0;
  if (S <= 0 || hq <= 0 || hk < 0 || D <= 0 || D % 2 != 0 ||
      row_stride < 0 || tokens > 0x7fffffffLL || tokens % S != 0 ||
      (long long)(hq + hk) * D > 0x7fffffffLL || (hk > 0 && !k))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, oq, ok, cos, sin, (int)tokens, S, hq, hk, D, row_stride, 1,
         hq + hk};
  cudaStream_t s = (cudaStream_t)stream;
  PTT_DISPATCH(x_dtype, T,
    PTT_DISPATCH(table_dtype, C,
      return transpose ? launch_rope<T, C, true>(a, vector, s)
                       : launch_rope<T, C, false>(a, vector, s)))
  return (int)cudaErrorInvalidValue;
}
