// Flash attention forward on Hopper's tensor cores: the bfloat16 and
// float16 route of flash_attention_fwd / flashmask_attention_fwd for head
// dims 64 and 128 (float32 and other head dims take flash_attention.cu).
//
//   q    [B, S_q, H, D]      k, v [B, S_k, H_kv, D]     (H % H_kv == 0)
//   out  [B, S_q, H, D]      lse  [B, H, S_q] float32
//
// Semantics are flash_attention.cu's: bottom-right causal (query i sees key
// t when i + (S_k - S_q) >= t), GQA by index (query head h reads KV head
// h / (H / H_kv), K and V never repeated), 0-2 masked row intervals per key
// with bound rows of kh in {1, H_kv, H} (flash_mask.cuh), masking by
// position (nothing read past S_q or S_k: TMA fills those rows with zeros
// and the scores are masked), NEG_INF = -1e30, l clamped at L_EPS, so a
// row that sees no key writes 0 and lse = NEG_INF + log(L_EPS).
//
// Rounding is the TPU kernel's (ops/primitive/tiles.py
// online_softmax_update with p_dtype = v.dtype): scores, the running max
// and l are float32 and l sums float32 P; P is rounded to the input type
// only as the A operand of the P V product, which accumulates in float32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:
// _flash_fwd_bhsd / _fwd_kernel (flash_attention_fwd; with the mask
// operands and _range_mask, flashmask_attention_fwd) and the JAX package's
// Pallas-on-GPU lowering of the same function,
// paddle_tpu/ops/primitive/lowering_gpu.py: _flash_fwd_gpu. What bounds it
// on the H100: operations (4 D per visible pair over 989 TFLOP/s in
// bf16) from S ~ 1k on; at S = 256 the bytes of q, k, v and out.
//
// Design: one block of two warpgroups per (batch x head, tile of BQ = 128
// query rows), each warpgroup owning 64 rows; tiles issued heaviest first
// (the last query tiles of a causal launch see the most keys). Q [128, D]
// and a two-stage ring of K and V tiles of BK = 128 keys sit in shared
// memory in wgmma's 128-byte-swizzled layout (flash_sm90.cuh), copied by
// TMA straight from the [B, S, H, D] tensors through 4-D tensor maps and
// completing on mbarriers: 32 + 2 x (32 + 32) = 160 KB at D = 128. One
// thread issues the copies of tile j + 1 while both warpgroups compute tile
// j. S = Q K^T is wgmma m64n128k16 from shared memory; the scale, the
// causal, length and range tests apply to the accumulator fragments by
// their (row, column); the online softmax runs on the fragments (the 4
// threads of a quad share a row: two shuffles); P, packed to 16 bits in
// registers, is the register A operand of O += P V (V the MN-major B
// operand). The loop ends at the last key the block's last query sees
// (tiles above the causal diagonal are never read); tiles the ranges mask
// whole are still computed, and tiles that no test can mask skip the
// tests. The tensor maps are encoded on the host at each call (a few us).
#include "flash_mask.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace ptt::sm90;
using ptt::Bounds;
using ptt::bound_row;
using ptt::range_visible;
using ptt::stage_bounds;

constexpr int kThreads = 256;   // two warpgroups
constexpr int BQ = 128;         // query rows per block
constexpr int BK = 128;         // keys per tile

// shared memory layout in bytes from the 1024-aligned base
template <int HD>
struct Smem {
  static constexpr int TILE = BK * HD * 2;           // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = BQ * HD * 2;              // K[2]
  static constexpr int V = K + 2 * TILE;             // V[2]
  static constexpr int BOUNDS = V + 2 * TILE;        // int [2][4][BK]
  static constexpr int BARS = BOUNDS + 2 * 4 * BK * 4;   // full[2], q
  static constexpr int BYTES = BARS + 3 * 8;
};

template <typename T, int HD, int NM>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      T* __restrict__ out, float* __restrict__ lse, Bounds mb,
                      int Sq, int Sk, int H, int Hkv, float scale,
                      int causal) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  int* bsm = reinterpret_cast<int*>(sm + L::BOUNDS);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // heaviest first
  const int off = Sk - Sq;                               // bottom-right
  // keys the tile's last real query can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int64_t mrow = NM ? bound_row(mb, b, h, g, H, Sk) : 0;

  auto load_kv = [&](int j) {
    const int s = j & 1;
    bar_expect(&bars[s], 2 * L::TILE);
    tma_tile<HD>(sm + L::K + s * L::TILE, &mk, &bars[s], BK, g, j * BK, b);
    tma_tile<HD>(sm + L::V + s * L::TILE, &mv, &bars[s], BK, g, j * BK, b);
  };
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    bar_init(&bars[2]);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(&bars[2], BQ * HD * 2);
    tma_tile<HD>(sm + L::Q, &mq, &bars[2], BQ, h, q0, b);
    if (n_tiles > 0) load_kv(0);
  }
  if constexpr (NM > 0)
    if (n_tiles > 0) stage_bounds<NM>(bsm, mb, mrow, 0, BK, Sk);

  const int qw = q0 + wg * 64;               // the warpgroup's first row
  const int r0 = qw + frag_row(t, 0), r1 = r0 + 8;
  const float sl2 = scale * LOG2E;
  // running max (in log2 units of the scaled scores) and per-thread
  // partial sums of P for rows r0 and r1
  float m0 = ptt::NEG_INF, m1 = ptt::NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t q_base = smem_addr(sm + L::Q) + wg * 64 * 128;

  bar_wait(&bars[2], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    // every thread is done with tile j - 1, whose stage the next copy fills
    __syncthreads();
    if (j + 1 < n_tiles) {
      if (tid == 0) load_kv(j + 1);
      if constexpr (NM > 0)
        stage_bounds<NM>(bsm + (s ^ 1) * 4 * BK, mb, mrow, (j + 1) * BK, BK,
                         Sk);
    }
    bar_wait(&bars[s], (j >> 1) & 1);
    const uint32_t k_base = smem_addr(sm + L::K + s * L::TILE);
    const uint32_t v_base = smem_addr(sm + L::V + s * L::TILE);

    float acc[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<T>(acc, desc_k(q_base + kstep(kk, BQ)),
                  desc_k(k_base + kstep(kk, BK)), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(acc);

    // scale into log2 units; masked scores become -inf, so exp2 gives 0
    // even while a row's max is still NEG_INF
    const int k0 = j * BK;
    const bool full = NM == 0 && k0 + BK <= Sk &&
                      (!causal || qw + off >= k0 + BK - 1);
    const int* bs = bsm + s * 4 * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = acc[i] * sl2;
      if (!full) {
        const int c = frag_col(t, i), kp = k0 + c;
        const int row = (i / 2) % 2 ? r1 : r0;
        if (!(kp < Sk && (!causal || row + off >= kp) &&
              range_visible<NM>(bs, BK, c, row)))
          x = -INFINITY;
      }
      acc[i] = x;
      if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2f(acc[i] - ((i / 2) % 2 ? n1 : n0));
      acc[i] = p;
      if ((i / 2) % 2) sum1 += p;
      else sum0 += p;
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i / 2) % 2 ? a1 : a0;

    // O += P V: P rounded to the input type in registers
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a_frag<T>(a, acc, kk);
      wgmma_rs<T>(o, a, desc_mn(v_base + kk * 16 * 128, BK * 128), 1);
    }
    wg_commit();
    wg_wait();
    fence_regs(o);
  }

  const float lc0 = fmaxf(quad_sum(l0), ptt::L_EPS);
  const float lc1 = fmaxf(quad_sum(l1), ptt::L_EPS);
  const int64_t row_stride = (int64_t)H * HD;
  T* ob = out + ((int64_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i / 2) % 2 ? r1 : r0;
    const float lc = (i / 2) % 2 ? lc1 : lc0;
    if (row < Sq)
      *reinterpret_cast<uint32_t*>(ob + row * row_stride + frag_col(t, i)) =
          pack2<T>(o[i] / lc, o[i + 1] / lc);
  }
  if (t % 4 == 0) {
    // m is NEG_INF exactly when the row saw no key
    if (r0 < Sq)
      lse[(int64_t)bh * Sq + r0] =
          (m0 == ptt::NEG_INF ? m0 : m0 * LN2) + logf(lc0);
    if (r1 < Sq)
      lse[(int64_t)bh * Sq + r1] =
          (m1 == ptt::NEG_INF ? m1 : m1 * LN2) + logf(lc1);
  }
}

template <typename T, int HD, int NM>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const Bounds& mb, int B, int Sq, int Sk, int H, int Hkv,
           float scale, int causal, int dtype, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, dtype, HD, H, Sq, B, BQ);
  if (!e) e = make_map(&mk, k, dtype, HD, Hkv, Sk, B, BK);
  if (!e) e = make_map(&mv, v, dtype, HD, Hkv, Sk, B, BK);
  if (e) return e;
  const size_t smem = Smem<HD>::BYTES + 1024;
  auto kern = flash_fwd_sm90_kernel<T, HD, NM>;
  e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kern<<<grid, kThreads, smem, s>>>(mq, mk, mv, (T*)out, lse, mb, Sq, Sk, H,
                                    Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_nm(const void* q, const void* k, const void* v, void* out,
              float* lse, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, float scale, int causal, int dtype,
              cudaStream_t s) {
  if (nm == 0)
    return launch<T, HD, 0>(q, k, v, out, lse, mb, B, Sq, Sk, H, Hkv, scale,
                            causal, dtype, s);
  if (nm == 1)
    return launch<T, HD, 1>(q, k, v, out, lse, mb, B, Sq, Sk, H, Hkv, scale,
                            causal, dtype, s);
  return launch<T, HD, 2>(q, k, v, out, lse, mb, B, Sq, Sk, H, Hkv, scale,
                          causal, dtype, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out,
             float* lse, const Bounds& mb, int nm, int B, int Sq, int Sk,
             int H, int Hkv, int D, float scale, int causal, int dtype,
             cudaStream_t s) {
  if (D == 64)
    return launch_nm<T, 64>(q, k, v, out, lse, mb, nm, B, Sq, Sk, H, Hkv,
                            scale, causal, dtype, s);
  return launch_nm<T, 128>(q, k, v, out, lse, mb, nm, B, Sq, Sk, H, Hkv,
                           scale, causal, dtype, s);
}

int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, int D, float scale, int causal, int dtype,
              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) ||
      (dtype != 1 && dtype != 2) || (long long)B * H > 0x7fffffffLL ||
      (Sq + BQ - 1) / BQ > 65535 || !ptt::bounds_ok(mb, nm, H, Hkv) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 2)
    return launch_t<__half>(q, k, v, out, (float*)lse, mb, nm, B, Sq, Sk, H,
                            Hkv, D, scale, causal, dtype, s);
  return launch_t<__nv_bfloat16>(q, k, v, out, (float*)lse, mb, nm, B, Sq,
                                 Sk, H, Hkv, D, scale, causal, dtype, s);
}

}  // namespace

extern "C" int ptt_flash_attention_fwd_sm90(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* lse, int B, int Sq, int Sk,
                                            int H, int Hkv, int D,
                                            float scale, int causal,
                                            int dtype, void* stream) {
  const Bounds none = {nullptr, nullptr, nullptr, nullptr, 1};
  return fwd_entry(q, k, v, out, lse, none, 0, B, Sq, Sk, H, Hkv, D, scale,
                   causal, dtype, stream);
}

// start/end (and start2/end2 when nm == 2): [B, kh, Sk] int32
extern "C" int ptt_flashmask_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D,
    float scale, int causal, int dtype, void* stream) {
  const Bounds mb = {(const int*)start, (const int*)end, (const int*)start2,
                     (const int*)end2, kh};
  return fwd_entry(q, k, v, out, lse, mb, nm, B, Sq, Sk, H, Hkv, D, scale,
                   causal, dtype, stream);
}
