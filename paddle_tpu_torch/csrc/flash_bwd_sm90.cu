// Flash attention backward on Hopper's tensor cores: the bfloat16 and
// float16 route of flash_attention_bwd / flashmask_attention_bwd for head
// dims 64 and 128 (float32 and other head dims take
// flash_attention_bwd.cu). dq, dk and dv of flash_fwd_sm90.cu, recomputing
// the probabilities from the forward's per-row logsumexp.
//
//   q, dout [B, S_q, H, D]     k, v, dk, dv [B, S_k, H_kv, D]  (H % H_kv == 0)
//   lse, delta [B, H, S_q] float32 (delta = rowsum(dout * out), computed
//   by the wrapper); dq [B, S_q, H, D]
//
//   P  = exp(S * scale - lse)   (0 where masked)     S = Q K^T
//   dV = P^T dO        dP = dO V^T       dS = P * (dP - delta)
//   dQ = dS K * scale  dK = dS^T Q * scale
//
// Masking is the forward's (bottom-right causal, lengths by position, 0-2
// range intervals per key with bound rows of kh in {1, H_kv, H}); P is
// zeroed by the mask, never by exp, so rows that see no key (lse -1e30)
// and padded query rows add nothing. Under GQA, dK and dV of KV head g sum
// the H / H_kv query heads that read it, in float32, rounded once.
//
// Rounding is the TPU kernel's (flash_attention.py _bwd_dq_kernel,
// _bwd_dkv_kernel): S, P, dP and dS are float32, and P and dS are rounded
// to the input type only as the A operands of the dV, dK and dQ products,
// which accumulate in float32.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// _flash_bwd_bhsd, its dq pallas_call (:360, body _bwd_dq_kernel) and its
// dk/dv pallas_call (:393, body _bwd_dkv_kernel), and the group sum of
// _flash_core_bwd (with the mask operands and _range_mask, the backward of
// flashmask_attention_fwd). What bounds it on the H100: operations, 10 D
// per visible pair over 989 TFLOP/s in bf16 (0.17 ms at [4, 2048, 16, 128]
// causal) against 0.04 ms of bytes.
//
// Design: two kernels, no atomics, deterministic; every product is wgmma
// (m64nNk16, float32 accumulators), every tile is copied by TMA through
// 4-D tensor maps over the [B, S, H, D] tensors into wgmma's swizzled
// layout (flash_sm90.cuh), completing on mbarriers, through a two-stage
// ring: one thread issues the copies of tile j + 1 while two warpgroups of
// 64 rows each compute tile j.
// - dQ: one block per (batch x head, 128 queries), heaviest first. Q, dO,
//   and (in registers) lse and delta stay resident; tiles of BKQ = 64 keys
//   of K and V come through the ring up to the last key the block's last
//   query sees. S = Q K^T and dP = dO V^T (shared-memory operands), then
//   dS in registers, rounded, is the A operand of dQ += dS K (K the
//   MN-major B operand).
// - dK/dV: one block per (batch, KV head, 128 keys). K and V stay
//   resident; the block walks the group's query heads and, for each, the
//   tiles of BQK = 64 queries from the first that sees the block's first
//   key (tiles above the causal diagonal are never read), Q and dO coming
//   through the ring with the tile's lse and delta. S^T = K Q^T and dP^T =
//   V dO^T, then P^T and dS^T in registers are the A operands of dV +=
//   P^T dO and dK += dS^T Q. dK and dV are summed over the group in
//   registers and written once.
// Registers: dQ 3 accumulators of 32, 32 and D / 2 floats a thread;
// dK/dV 4 of 32, 32, D / 2, D / 2 (PERF.md records ptxas's counts).
#include "flash_mask.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace ptt::sm90;
using ptt::Bounds;
using ptt::bound_row;
using ptt::range_visible;
using ptt::stage_bounds;

constexpr int kThreads = 256;   // two warpgroups
constexpr int BQ = 128;         // dQ: query rows per block
constexpr int BKQ = 64;         // dQ: keys per tile
constexpr int BKV = 128;        // dK/dV: keys per block
constexpr int BQK = 64;         // dK/dV: queries per tile

template <int HD>
struct SmemDq {
  static constexpr int TILE = BKQ * HD * 2;          // one K or V tile
  static constexpr int Q = 0;
  static constexpr int DO = BQ * HD * 2;
  static constexpr int K = DO + BQ * HD * 2;         // K[2]
  static constexpr int V = K + 2 * TILE;             // V[2]
  static constexpr int BOUNDS = V + 2 * TILE;        // int [2][4][BKQ]
  static constexpr int BARS = BOUNDS + 2 * 4 * BKQ * 4;  // full[2], q/do
  static constexpr int BYTES = BARS + 3 * 8;
};

template <int HD>
struct SmemDkv {
  static constexpr int TILE = BQK * HD * 2;          // one Q or dO tile
  static constexpr int K = 0;
  static constexpr int V = BKV * HD * 2;
  static constexpr int Q = V + BKV * HD * 2;         // Q[2]
  static constexpr int DO = Q + 2 * TILE;            // dO[2]
  static constexpr int SIDE = DO + 2 * TILE;         // float [2][2][BQK]
  static constexpr int BARS = SIDE + 2 * 2 * BQK * 4;    // full[2], k/v
  static constexpr int BYTES = BARS + 3 * 8;
};

template <typename T, int HD, int NM>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     Bounds mb, int Sq, int Sk, int H, int Hkv, float scale,
                     int causal) {
  using L = SmemDq<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  int* bsm = reinterpret_cast<int*>(sm + L::BOUNDS);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // heaviest first
  const int off = Sk - Sq;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + off + 1) : Sk;
  const int n_tiles = k_end > 0 ? (k_end + BKQ - 1) / BKQ : 0;
  const int64_t mrow = NM ? bound_row(mb, b, h, g, H, Sk) : 0;

  auto load_kv = [&](int j) {
    const int s = j & 1;
    bar_expect(&bars[s], 2 * L::TILE);
    tma_tile<HD>(sm + L::K + s * L::TILE, &mk, &bars[s], BKQ, g, j * BKQ, b);
    tma_tile<HD>(sm + L::V + s * L::TILE, &mv, &bars[s], BKQ, g, j * BKQ, b);
  };
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    bar_init(&bars[2]);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(&bars[2], 2 * BQ * HD * 2);
    tma_tile<HD>(sm + L::Q, &mq, &bars[2], BQ, h, q0, b);
    tma_tile<HD>(sm + L::DO, &mdo, &bars[2], BQ, h, q0, b);
    if (n_tiles > 0) load_kv(0);
  }
  if constexpr (NM > 0)
    if (n_tiles > 0) stage_bounds<NM>(bsm, mb, mrow, 0, BKQ, Sk);

  const int qw = q0 + wg * 64;
  const int r0 = qw + frag_row(t, 0), r1 = r0 + 8;
  const float sl2 = scale * LOG2E;
  const float lse0 = r0 < Sq ? lse[(int64_t)bh * Sq + r0] * LOG2E : 0.f;
  const float lse1 = r1 < Sq ? lse[(int64_t)bh * Sq + r1] * LOG2E : 0.f;
  const float dl0 = r0 < Sq ? delta[(int64_t)bh * Sq + r0] : 0.f;
  const float dl1 = r1 < Sq ? delta[(int64_t)bh * Sq + r1] : 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = smem_addr(sm + L::Q) + wg * 64 * 128;
  const uint32_t do_base = smem_addr(sm + L::DO) + wg * 64 * 128;

  bar_wait(&bars[2], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    __syncthreads();                 // tile j - 1's stage is free
    if (j + 1 < n_tiles) {
      if (tid == 0) load_kv(j + 1);
      if constexpr (NM > 0)
        stage_bounds<NM>(bsm + (s ^ 1) * 4 * BKQ, mb, mrow, (j + 1) * BKQ,
                         BKQ, Sk);
    }
    bar_wait(&bars[s], (j >> 1) & 1);
    const uint32_t k_base = smem_addr(sm + L::K + s * L::TILE);
    const uint32_t v_base = smem_addr(sm + L::V + s * L::TILE);

    float sc[BKQ / 2], dp[BKQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<T>(sc, desc_k(q_base + kstep(kk, BQ)),
                  desc_k(k_base + kstep(kk, BKQ)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<T>(dp, desc_k(do_base + kstep(kk, BQ)),
                  desc_k(v_base + kstep(kk, BKQ)), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = j * BKQ;
    const bool full = NM == 0 && k0 + BKQ <= Sk &&
                      (!causal || qw + off >= k0 + BKQ - 1);
    const int* bs = bsm + s * 4 * BKQ;
#pragma unroll
    for (int i = 0; i < BKQ / 2; ++i) {
      const bool hi = (i / 2) % 2;
      bool ok = true;
      if (!full) {
        const int c = frag_col(t, i), kp = k0 + c;
        const int row = hi ? r1 : r0;
        ok = kp < Sk && (!causal || row + off >= kp) &&
             range_visible<NM>(bs, BKQ, c, row);
      }
      const float p = ok ? exp2f(sc[i] * sl2 - (hi ? lse1 : lse0)) : 0.f;
      sc[i] = p * (dp[i] - (hi ? dl1 : dl0));          // dS
    }

    // dQ += dS K: dS rounded to the input type in registers
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKQ / 16; ++kk) {
      uint32_t a[4];
      a_frag<T>(a, sc, kk);
      wgmma_rs<T>(acc, a, desc_mn(k_base + kk * 16 * 128, BKQ * 128), 1);
    }
    wg_commit();
    wg_wait();
    fence_regs(acc);
  }

  const int64_t row_stride = (int64_t)H * HD;
  T* dqb = dq + ((int64_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i / 2) % 2 ? r1 : r0;
    if (row < Sq)
      *reinterpret_cast<uint32_t*>(dqb + row * row_stride + frag_col(t, i)) =
          pack2<T>(acc[i] * scale, acc[i + 1] * scale);
  }
}

// the masked intervals of one key of query head h's bound row, in
// registers: [start, end) and, with NM = 2, [start2, end2)
template <int NM>
struct KeyBounds {
  int s1, e1, s2, e2;
  __device__ __forceinline__ void load(const Bounds& mb, int64_t row, int kp,
                                       int Sk) {
    s1 = e1 = s2 = e2 = 0;
    if (NM == 0 || kp >= Sk) return;
    s1 = mb.start[row + kp];
    e1 = mb.end[row + kp];
    if (NM == 2) {
      s2 = mb.start2[row + kp];
      e2 = mb.end2[row + kp];
    }
  }
  __device__ __forceinline__ bool visible(int qi) const {
    if (NM == 0) return true;
    bool masked = s1 <= qi && qi < e1;
    if (NM == 2) masked = masked || (s2 <= qi && qi < e2);
    return !masked;
  }
};

template <typename T, int HD, int NM>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mdo,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Bounds mb, int Sq, int Sk, int H,
                      int Hkv, float scale, int causal) {
  using L = SmemDkv<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  float* side = reinterpret_cast<float*>(sm + L::SIDE);  // [2][lse2, delta]

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * BKV;       // low tiles see the most queries
  const int off = Sk - Sq;
  // the first query that sees key k0, rounded down to its tile
  const int q_first = causal ? max(0, k0 - off) : 0;
  const int qt0 = (q_first / BQK) * BQK;
  const int n_qt = qt0 < Sq ? (Sq - qt0 + BQK - 1) / BQK : 0;
  const int n_tiles = rep * n_qt;

  // tile it: query head g * rep + it / n_qt, queries from its q0
  auto tile_q0 = [&](int it) { return qt0 + (it % n_qt) * BQK; };
  auto tile_h = [&](int it) { return g * rep + it / n_qt; };
  auto load_q = [&](int it) {
    const int s = it & 1;
    bar_expect(&bars[s], 2 * L::TILE);
    tma_tile<HD>(sm + L::Q + s * L::TILE, &mq, &bars[s], BQK, tile_h(it),
                 tile_q0(it), b);
    tma_tile<HD>(sm + L::DO + s * L::TILE, &mdo, &bars[s], BQK, tile_h(it),
                 tile_q0(it), b);
  };
  // the tile's lse (in log2 units) and delta, 0 past S_q
  auto stage_side = [&](int it) {
    float* sd = side + (it & 1) * 2 * BQK;
    const int64_t row = ((int64_t)b * H + tile_h(it)) * Sq;
    const int qa = tile_q0(it);
    for (int c = tid; c < BQK; c += kThreads) {
      const int qi = qa + c;
      sd[c] = qi < Sq ? lse[row + qi] * LOG2E : 0.f;
      sd[BQK + c] = qi < Sq ? delta[row + qi] : 0.f;
    }
  };
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    bar_init(&bars[2]);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(&bars[2], 2 * BKV * HD * 2);
    tma_tile<HD>(sm + L::K, &mk, &bars[2], BKV, g, k0, b);
    tma_tile<HD>(sm + L::V, &mv, &bars[2], BKV, g, k0, b);
    if (n_tiles > 0) load_q(0);
  }
  if (n_tiles > 0) stage_side(0);

  const int kw = k0 + wg * 64;           // the warpgroup's first key
  const int kr0 = kw + frag_row(t, 0), kr1 = kr0 + 8;
  const float sl2 = scale * LOG2E;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  KeyBounds<NM> kb0, kb1;
  const uint32_t k_base = smem_addr(sm + L::K) + wg * 64 * 128;
  const uint32_t v_base = smem_addr(sm + L::V) + wg * 64 * 128;

  bar_wait(&bars[2], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it & 1;
    __syncthreads();                 // tile it - 1's stage is free
    if (it + 1 < n_tiles) {
      if (tid == 0) load_q(it + 1);
      stage_side(it + 1);
    }
    const int q0 = tile_q0(it);
    if constexpr (NM > 0) {
      // the keys' bounds for this head: the row changes with the head
      // only when kh = H
      if (it == 0 || (q0 == qt0 && mb.kh == H)) {
        const int64_t row = bound_row(mb, b, tile_h(it), g, H, Sk);
        kb0.load(mb, row, kr0, Sk);
        kb1.load(mb, row, kr1, Sk);
      }
    }
    bar_wait(&bars[s], (it >> 1) & 1);
    const uint32_t q_s = smem_addr(sm + L::Q + s * L::TILE);
    const uint32_t do_s = smem_addr(sm + L::DO + s * L::TILE);

    float st[BQK / 2], dpt[BQK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<T>(st, desc_k(k_base + kstep(kk, BKV)),
                  desc_k(q_s + kstep(kk, BQK)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<T>(dpt, desc_k(v_base + kstep(kk, BKV)),
                  desc_k(do_s + kstep(kk, BQK)), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(st);
    fence_regs(dpt);

    const float* sd = side + s * 2 * BQK;
    // padded query rows add nothing to dK / dV
    const bool full = NM == 0 && kw + 63 < Sk && q0 + BQK <= Sq &&
                      (!causal || q0 + off >= kw + 63);
#pragma unroll
    for (int i = 0; i < BQK / 2; ++i) {
      const bool hi = (i / 2) % 2;
      const int c = frag_col(t, i);
      bool ok = true;
      if (!full) {
        const int qi = q0 + c, kp = hi ? kr1 : kr0;
        ok = qi < Sq && kp < Sk && (!causal || qi + off >= kp) &&
             (hi ? kb1 : kb0).visible(qi);
      }
      const float p = ok ? exp2f(st[i] * sl2 - sd[c]) : 0.f;
      dpt[i] = p * (dpt[i] - sd[BQK + c]);            // dS^T
      st[i] = p;                                      // P^T
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded in registers
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQK / 16; ++kk) {
      uint32_t a[4];
      a_frag<T>(a, st, kk);
      wgmma_rs<T>(dva, a, desc_mn(do_s + kk * 16 * 128, BQK * 128), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BQK / 16; ++kk) {
      uint32_t a[4];
      a_frag<T>(a, dpt, kk);
      wgmma_rs<T>(dka, a, desc_mn(q_s + kk * 16 * 128, BQK * 128), 1);
    }
    wg_commit();
    wg_wait();
    fence_regs(dva);
    fence_regs(dka);
  }

  const int64_t row_stride = (int64_t)Hkv * HD;
  T* dkb = dk + ((int64_t)b * Sk * Hkv + g) * HD;
  T* dvb = dv + ((int64_t)b * Sk * Hkv + g) * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int kp = (i / 2) % 2 ? kr1 : kr0;
    if (kp < Sk) {
      const int64_t at = kp * row_stride + frag_col(t, i);
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack2<T>(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + at) = pack2<T>(dva[i], dva[i + 1]);
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD, int NM>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const Bounds& mb, int B, int Sq, int Sk, int H, int Hkv,
           float scale, int causal, int dtype, cudaStream_t s) {
  // the dQ kernel's maps: 128-row Q and dO, 64-row K and V tiles; the
  // dK/dV kernel's: 64-row Q and dO, 128-row K and V
  CUtensorMap mq, mdo, mk, mv;
  int e = make_map(&mq, q, dtype, HD, H, Sq, B, BQ);
  if (!e) e = make_map(&mdo, dout, dtype, HD, H, Sq, B, BQ);
  if (!e) e = make_map(&mk, k, dtype, HD, Hkv, Sk, B, BKQ);
  if (!e) e = make_map(&mv, v, dtype, HD, Hkv, Sk, B, BKQ);
  if (e) return e;
  const size_t smem_q = SmemDq<HD>::BYTES + 1024;
  auto kq = flash_dq_sm90_kernel<T, HD, NM>;
  if ((e = allow_smem(kq, smem_q))) return e;
  dim3 grid_q((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kq<<<grid_q, kThreads, smem_q, s>>>(mq, mdo, mk, mv, lse, delta, (T*)dq,
                                      mb, Sq, Sk, H, Hkv, scale, causal);
  e = (int)cudaGetLastError();
  if (e || Sk == 0) return e;

  e = make_map(&mq, q, dtype, HD, H, Sq, B, BQK);
  if (!e) e = make_map(&mdo, dout, dtype, HD, H, Sq, B, BQK);
  if (!e) e = make_map(&mk, k, dtype, HD, Hkv, Sk, B, BKV);
  if (!e) e = make_map(&mv, v, dtype, HD, Hkv, Sk, B, BKV);
  if (e) return e;
  const size_t smem_kv = SmemDkv<HD>::BYTES + 1024;
  auto kkv = flash_dkv_sm90_kernel<T, HD, NM>;
  if ((e = allow_smem(kkv, smem_kv))) return e;
  dim3 grid_kv((unsigned)(B * Hkv), (unsigned)((Sk + BKV - 1) / BKV));
  kkv<<<grid_kv, kThreads, smem_kv, s>>>(mq, mdo, mk, mv, lse, delta,
                                         (T*)dk, (T*)dv, mb, Sq, Sk, H, Hkv,
                                         scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_nm(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, float scale, int causal, int dtype,
              cudaStream_t s) {
  if (nm == 0)
    return launch<T, HD, 0>(q, k, v, dout, lse, delta, dq, dk, dv, mb, B, Sq,
                            Sk, H, Hkv, scale, causal, dtype, s);
  if (nm == 1)
    return launch<T, HD, 1>(q, k, v, dout, lse, delta, dq, dk, dv, mb, B, Sq,
                            Sk, H, Hkv, scale, causal, dtype, s);
  return launch<T, HD, 2>(q, k, v, dout, lse, delta, dq, dk, dv, mb, B, Sq,
                          Sk, H, Hkv, scale, causal, dtype, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, const Bounds& mb, int nm, int B, int Sq, int Sk, int H,
             int Hkv, int D, float scale, int causal, int dtype,
             cudaStream_t s) {
  if (D == 64)
    return launch_nm<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, mb, nm, B,
                            Sq, Sk, H, Hkv, scale, causal, dtype, s);
  return launch_nm<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, mb, nm, B,
                           Sq, Sk, H, Hkv, scale, causal, dtype, s);
}

int bwd_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, const Bounds& mb, int nm, int B, int Sq, int Sk,
              int H, int Hkv, int D, float scale, int causal, int dtype,
              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk < 0 || Hkv <= 0 || H % Hkv != 0 || (D != 64 && D != 128) ||
      (dtype != 1 && dtype != 2) || (long long)B * H > 0x7fffffffLL ||
      (Sq + BQ - 1) / BQ > 65535 || (Sk + BKV - 1) / BKV > 65535 ||
      !ptt::bounds_ok(mb, nm, H, Hkv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 2)
    return launch_t<__half>(q, k, v, dout, l, dl, dq, dk, dv, mb, nm, B, Sq,
                            Sk, H, Hkv, D, scale, causal, dtype, s);
  return launch_t<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk, dv, mb, nm, B,
                                 Sq, Sk, H, Hkv, D, scale, causal, dtype, s);
}

}  // namespace

extern "C" int ptt_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int Sq, int Sk, int H, int Hkv, int D, float scale, int causal,
    int dtype, void* stream) {
  const Bounds none = {nullptr, nullptr, nullptr, nullptr, 1};
  return bwd_entry(q, k, v, dout, lse, delta, dq, dk, dv, none, 0, B, Sq, Sk,
                   H, Hkv, D, scale, causal, dtype, stream);
}

// start/end (and start2/end2 when nm == 2): [B, kh, Sk] int32
extern "C" int ptt_flashmask_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D,
    float scale, int causal, int dtype, void* stream) {
  const Bounds mb = {(const int*)start, (const int*)end, (const int*)start2,
                     (const int*)end2, kh};
  return bwd_entry(q, k, v, dout, lse, delta, dq, dk, dv, mb, nm, B, Sq, Sk,
                   H, Hkv, D, scale, causal, dtype, stream);
}
