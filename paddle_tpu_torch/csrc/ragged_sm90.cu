// Ragged paged attention on Hopper's tensor cores: the bfloat16 and float16
// route of ragged_paged_attention (pages in q's type) and
// ragged_paged_attention_int8 (int8 code pages with per-page float32
// scales), for head dims 64 and 128 and pages of a multiple of 8 tokens.
// Float32, other head dims and smaller pages take ragged_attention.cuh.
//
//   q          [C, Q_max, H, D]     right-padded; row r's q_lens[r] real
//                                   queries sit at the TAIL of its context:
//                                   query i is at position ctx - q_len + i
//   k/v pages  [N, page, H_kv, D]   q's type, or int8 codes with k/v
//                                   scales [N] float32 (a page's values are
//                                   code * scale / 127)
//   block_tables [C, P], context_lens [C], q_lens [C]   int32, on the card
//   out        [C, Q_max, H, D]     padded query rows are 0
//
// Semantics are ragged_attention.cuh's: key k_pos is visible to query i
// when k_pos <= ctx - q_len + i, k_pos < ctx and i < q_len (by position,
// never by page id: tables are padded with trash page 0), NEG_INF = -1e30,
// l clamped at L_EPS, so a row that sees no key writes 0.
//
// Rounding: scores, the running max and l are float32, and l sums float32
// P. P is rounded to q's type only as the register A operand of the P V
// product, which accumulates in float32 (the flash kernels' rounding). The
// TPU kernels keep P in float32 here; the port's plain versions model the
// kernel with p_dtype. With int8 pages the rounded value is P times the
// key's V multiplier.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/ragged_attention.py:
// _ragged_kernel (ragged_paged_attention) and
// paddle_tpu/ops/pallas/quantized_attention.py: _ragged_int8_kernel
// (ragged_paged_attention_int8). What bounds them on the H100: bytes at
// serving shapes (each row's K and V up to its context, q and out; a
// decode row's 1 query does 4 D operations per 4 D bytes of bf16 K/V), and
// operations (4 D per visible (query, key) pair and head over 989 TFLOP/s)
// for a 256-query chunk over a context above ~2k.
//
// Design. One block per (tile of flat query rows j = q_idx * rep + r of
// one KV group, KV head, batch row): the Pallas kernel's rows, so one K/V
// read serves all rep heads of the group, and every block of the group's
// tile shares its page reads. A block's two consumer warpgroups own 64
// flat rows each (wgmma M = 64): 128 positions at rep 1, 32 positions x 4
// heads at rep 4 (one warpgroup a block measured slower at every smoke
// row: fewer rows share each page read, and a block still holds an SM).
// The blocks rank the (row, query tile) items by the keys they see, from
// the lengths on the card, and the grid starts the heaviest first; a
// tile past the row's q_len writes zeros and reads nothing; the key loop
// stops at the last key the tile's last real query can see, so pages at
// or past the context are never read.
//
// Staging. The page pool [N, page, H_kv, D] is paddle's [B, S, heads, D]
// layout with B = N and S = page, so one TMA box of PB = gcd(page, 64)
// rows of one KV head (flash_sm90.cuh make_map) lies inside one page, and
// the boxes of a key tile of BK = 64 keys (4 pages of 16), fetched at the
// page ids of block_tables, stack into a [64][64]-per-column-block tile in
// wgmma's 128-byte-swizzled layout. Warp 0 issues the copies of tile
// j + 3 into a four-stage mbarrier ring while the warpgroups compute tile
// j, so that three tiles' copies are in flight beside the products (a
// block's walk is a chain of dependent tiles; with one copy in flight it
// waits a memory latency per tile). Lane b copies page box b: it reads its table
// entry itself from device memory, one tile ahead, so the load that names
// a page is never waited on beside the copy (nothing on the host reads
// context_lens or q_lens). Q [positions][rep
// heads][D] is one strided TMA box per column block (a map with a head box
// of rep). Keys of the last tile past the tile's last visible key are
// masked and their V rows zeroed (rows never loaded, or a page's rows past
// the context), so that 0 * garbage is never NaN.
//
// Products. S = Q K^T is wgmma m64n64k16 from shared memory (K-major); the
// scale and the position mask apply to the accumulator fragment by (row,
// column); the online softmax runs on the fragments (a quad of threads
// shares a row); P, packed to 16 bits, is the register A operand of
// O += P V (V MN-major, tnspB). The output goes through shared memory and
// leaves in 16-byte stores.
//
// int8 pages. TMA cannot convert types: the int8 codes of a tile are
// copied raw ([PB][D] bytes a box, no swizzle) into the ring, and
// the block turns them into 16-bit values (exact: |code| <= 127) in the
// swizzled K and V tiles before the products. k_scale[pid] / 127 is folded
// into each key's score column and v_scale[pid] / 127 into each key's P
// before P is rounded, as decode_attention.cuh does: a float pool never
// exists. Each issuing lane loads its page's scales with its copy.
#include "flash_sm90.cuh"

namespace {

using namespace ptt::sm90;

constexpr int BK = 64;                 // keys per tile
constexpr int NWG = 2;                 // consumer warpgroups a block
constexpr int BM = 64 * NWG;           // flat query rows a block
constexpr int MAX_BOXES = BK / 8;      // page boxes per tile (PB >= 8)
constexpr int STAGES = 4;              // the ring of key tiles
constexpr int MAX_RANKED = 256;        // (row, query tile) items ranked

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// shared memory layout in bytes from the 1024-aligned base
template <typename KV, int HD>
struct Smem {
  static constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static constexpr int OSTRIDE = HD + 8;               // output stage row
  static constexpr int TILE = BK * HD * 2;             // one 16-bit tile
  static constexpr int RAW_TILE = BK * HD;             // one int8 tile
  static constexpr int Q = 0;            // Q, then the output stage
  static constexpr int K = round1024(BM * OSTRIDE * 2);
  // float pages: K[STAGES], V[STAGES] (the ring); int8: K, V (converted)
  static constexpr int V = K + (INT8 ? 1 : STAGES) * TILE;
  static constexpr int RAW = V + (INT8 ? 1 : STAGES) * TILE;
  // int8: codes [STAGES][K, V], then float [STAGES][k, v][MAX_BOXES]
  // multipliers
  static constexpr int MUL = RAW + (INT8 ? 2 * STAGES * RAW_TILE : 0);
  static constexpr int BARS = MUL + (INT8 ? STAGES * 2 * MAX_BOXES * 4 : 0);
  static constexpr int BYTES = BARS + (STAGES + 1) * 8;  // full[], q
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 8 int8 codes -> 8 16-bit values, one 16-byte chunk
template <typename T>
__device__ __forceinline__ uint4 codes16(uint2 raw) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 v;
  v.x = pack2<T>((float)c[0], (float)c[1]);
  v.y = pack2<T>((float)c[2], (float)c[3]);
  v.z = pack2<T>((float)c[4], (float)c[5]);
  v.w = pack2<T>((float)c[6], (float)c[7]);
  return v;
}

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(128 * NWG)
ragged_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ bt, const int* __restrict__ cl,
                   const int* __restrict__ ql, T* __restrict__ out, int Qmax,
                   int H, int Hkv, int page, int P, int QT, int ntq,
                   int pb_shift, float scale) {
  using L = Smem<KV, HD>;
  constexpr bool INT8 = L::INT8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  float* mul = reinterpret_cast<float*>(sm + L::MUL);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int nt = blockDim.x;
  const int g = blockIdx.x, rep = H / Hkv;

  // the (row, query tile) item of this block: the blocks of one y launch
  // together, so each block ranks the items by the keys they see
  // (heaviest first, ties by index; padding-only tiles last) and takes
  // the one of rank blockIdx.y; the longest walks then start first
  // whatever the rows' order. Past MAX_RANKED items: the last query tile
  // of each row first.
  const int n_items = gridDim.y;
  auto item_keys = [&](int it) {
    const int r = it / ntq, q0i = it % ntq * QT, c = cl[r], n = ql[r];
    if (q0i >= n) return -1;
    const int last = min(min(q0i + QT, Qmax), n) - 1;
    return max(0, min(min(c - n + last, c - 1) + 1, P * page));
  };
  __shared__ int item_s;
  if (n_items <= MAX_RANKED) {
    int* keys_s = reinterpret_cast<int*>(sm + L::Q);   // before Q lands
    for (int i = tid; i < n_items; i += nt) keys_s[i] = item_keys(i);
    __syncthreads();
    for (int i = tid; i < n_items; i += nt) {
      const int ki = keys_s[i];
      int rank = 0;
      for (int k = 0; k < n_items; ++k) {
        const int kk = keys_s[k];
        rank += kk > ki || (kk == ki && k < i);
      }
      if (rank == (int)blockIdx.y) item_s = i;
    }
    fence_async_smem();                  // Q's copy reuses keys_s's bytes
  } else if (tid == 0) {
    const int rows = n_items / ntq, by = blockIdx.y;
    item_s = by % rows * ntq + ntq - 1 - by / rows;
  }
  __syncthreads();
  const int64_t row = item_s / ntq;
  const int q0 = item_s % ntq * QT;
  const int ctx = cl[row], q_len = ql[row];
  const int q_end = min(q0 + QT, Qmax);
  const int64_t pos_stride = (int64_t)H * HD;
  T* ob = out + row * Qmax * pos_stride + (int64_t)g * rep * HD;
  const int per_row = HD / 8;                  // 16-byte chunks of a row

  if (q0 >= q_len) {                           // all padding: zeros
    const int per_pos = rep * per_row;
    for (int i = tid; i < (q_end - q0) * per_pos; i += nt)
      reinterpret_cast<uint4*>(ob + (q0 + i / per_pos) * pos_stride)
          [i % per_pos] = make_uint4(0, 0, 0, 0);
    return;
  }

  // keys the tile's last real query can see (never past the table)
  const int q_last = min(q_end, q_len) - 1;
  const int n_keys =
      max(0, min(min(ctx - q_len + q_last, ctx - 1) + 1, P * page));
  const int n_tiles = (n_keys + BK - 1) / BK;
  const int PB = 1 << pb_shift;                // rows of one page box
  const int nb_full = BK >> pb_shift;          // boxes of a whole tile
  auto boxes = [&](int jt) {
    return min(nb_full, (n_keys - jt * BK + PB - 1) >> pb_shift);
  };

  // warp 0 issues the copies: lane b < boxes(jt) owns page box b of tile
  // jt (its table entry, its TMA boxes and, int8, its page's scales),
  // reading the entry one tile ahead of its copy
  const int lane = tid % 32;
  const bool producer = tid < 32;
  auto page_id = [&](int jt) {
    return jt < n_tiles && lane < boxes(jt)
        ? bt[row * P + (jt * BK + (lane << pb_shift)) / page] : 0;
  };
  auto issue = [&](int jt, int pid) {       // all of warp 0
    const int s = jt % STAGES, nb = boxes(jt);
    if (lane == 0) bar_expect(&bars[s], nb * PB * HD * (INT8 ? 2 : 4));
    __syncwarp();
    if (lane < nb) {
      const int off = (jt * BK + (lane << pb_shift)) % page;
      if constexpr (INT8) {
        uint8_t* raw = sm + L::RAW + 2 * s * L::RAW_TILE + lane * PB * HD;
        tma_box(raw, &mk, &bars[s], 0, g, off, pid);
        tma_box(raw + L::RAW_TILE, &mv, &bars[s], 0, g, off, pid);
      } else {
#pragma unroll
        for (int cb = 0; cb < HD / 64; ++cb) {
          const int at = s * L::TILE + cb * BK * 128 + lane * PB * 128;
          tma_box(sm + L::K + at, &mk, &bars[s], cb * 64, g, off, pid);
          tma_box(sm + L::V + at, &mv, &bars[s], cb * 64, g, off, pid);
        }
      }
    }
  };
  // int8: the K and V multipliers of a tile's boxes (0 past its boxes, so
  // that a masked key's P stays 0)
  auto store_mul = [&](int jt, float k_sc, float v_sc) {
    if (lane < MAX_BOXES) {
      float* m = mul + (jt % STAGES) * 2 * MAX_BOXES;
      m[lane] = k_sc * ptt::INV_QMAX;
      m[MAX_BOXES + lane] = v_sc * ptt::INV_QMAX;
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) bar_init(&bars[i]);
    bar_init_fence();
  }
  __syncthreads();
  int nxt = 0;                       // warp 0: page id of the next copy
  float ksc = 0.f, vsc = 0.f;        // warp 0, int8: its scales in flight
  if (producer) {
    if (lane == 0) {
      bar_expect(&bars[STAGES], QT * rep * HD * 2);
#pragma unroll
      for (int cb = 0; cb < HD / 64; ++cb)
        tma_box(sm + L::Q + cb * BM * 128, &mq, &bars[STAGES], cb * 64,
                g * rep, q0, (int)row);
    }
    int ids[STAGES - 1];             // the first STAGES - 1 tiles at once
#pragma unroll
    for (int jt = 0; jt < STAGES - 1; ++jt) ids[jt] = page_id(jt);
#pragma unroll
    for (int jt = 0; jt < STAGES - 1; ++jt)
      if (jt < n_tiles) issue(jt, ids[jt]);
    if constexpr (INT8) {
      float kp[STAGES - 1], vp[STAGES - 1];
#pragma unroll
      for (int jt = 0; jt < STAGES - 1; ++jt) {
        const bool has = jt < n_tiles && lane < boxes(jt);
        kp[jt] = has ? ks[ids[jt]] : 0.f;
        vp[jt] = has ? vs[ids[jt]] : 0.f;
      }
#pragma unroll
      for (int jt = 0; jt < STAGES - 1; ++jt) store_mul(jt, kp[jt], vp[jt]);
    }
    nxt = page_id(STAGES - 1);
  }

  // this thread's two flat rows and the last key each may see (-1: none)
  const int jr0 = wg * 64 + frag_row(t, 0), jr1 = jr0 + 8;
  auto limit = [&](int jr) {
    const int qi = q0 + jr / rep;
    return (jr < QT * rep && qi < q_len) ? min(ctx - q_len + qi, ctx - 1)
                                         : -1;
  };
  const int lim0 = limit(jr0), lim1 = limit(jr1);
  // a warpgroup whose rows are all padding skips the products
  const bool live = wg * 64 < QT * rep && q0 + wg * 64 / rep < q_len;
  const float sl2 = scale * LOG2E;
  float m0 = ptt::NEG_INF, m1 = ptt::NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t q_base = smem_addr(sm + L::Q) + wg * 64 * 128;

  bar_wait(&bars[STAGES], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int jn = j + STAGES - 1;           // the tile whose copy starts
    // every thread is done with tile j - 1, whose stage the copy fills
    __syncthreads();
    if (producer && jn < n_tiles) {
      issue(jn, nxt);
      if constexpr (INT8) {
        const bool has = lane < boxes(jn);
        ksc = has ? ks[nxt] : 0.f;
        vsc = has ? vs[nxt] : 0.f;
      }
      nxt = page_id(jn + 1);
    }
    bar_wait(&bars[s], (j / STAGES) & 1);
    const int k0 = j * BK;
    // keys of this tile some row may see; V rows past them are zeroed
    // (the last page's rows past the context may hold anything)
    const int rows = min(BK, n_keys - k0);
    uint32_t k_base, v_base;
    if constexpr (INT8) {
      // codes -> 16-bit values in the swizzled tiles; rows past `rows` -> 0
      const int chunks = BK * per_row;
      for (int i = tid; i < 2 * chunks; i += nt) {
        const int which = i / chunks, ci = i % chunks;
        const int r = ci / per_row, c = ci % per_row;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < rows)
          v = codes16<T>(*reinterpret_cast<const uint2*>(
              sm + L::RAW + (2 * s + which) * L::RAW_TILE + r * HD + c * 8));
        *reinterpret_cast<uint4*>(sm + (which ? L::V : L::K) +
                                  (c / 8) * BK * 128 + r * 128 +
                                  ((c % 8) ^ (r & 7)) * 16) = v;
      }
      fence_async_smem();
      __syncthreads();
      k_base = smem_addr(sm + L::K);
      v_base = smem_addr(sm + L::V);
    } else {
      k_base = smem_addr(sm + L::K + s * L::TILE);
      v_base = smem_addr(sm + L::V + s * L::TILE);
      if (rows < BK) {                         // the last tile
        for (int i = tid; i < (BK - rows) * per_row; i += nt) {
          const int r = rows + i / per_row, c = i % per_row;
          *reinterpret_cast<uint4*>(sm + L::V + s * L::TILE +
                                    (c / 8) * BK * 128 + r * 128 +
                                    (c % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();
        __syncthreads();
      }
    }

    if (live) {
      float acc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<T>(acc, desc_k(q_base + kstep(kk, BM)),
                    desc_k(k_base + kstep(kk, BK)), kk > 0);
      wg_commit();
      wg_wait();
      fence_regs(acc);

      // scale into log2 units (int8: times the key's K multiplier); keys
      // a row may not see become -inf, so exp2 gives 0 even while the
      // row's max is still NEG_INF
      const float* kmul = mul + s * 2 * MAX_BOXES;
      const float* vmul = kmul + MAX_BOXES;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = frag_col(t, i);
        float x = acc[i] * sl2;
        if constexpr (INT8) x *= kmul[c >> pb_shift];
        if (k0 + c > ((i / 2) % 2 ? lim1 : lim0)) x = -INFINITY;
        acc[i] = x;
        if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      const float n0 = fmaxf(m0, quad_max(mx0));
      const float n1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float p = exp2f(acc[i] - ((i / 2) % 2 ? n1 : n0));
        if ((i / 2) % 2) sum1 += p;
        else sum0 += p;
        if constexpr (INT8) p *= vmul[frag_col(t, i) >> pb_shift];
        acc[i] = p;
      }
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= (i / 2) % 2 ? a1 : a0;

      // O += P V: P rounded to q's type in registers
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
    if constexpr (INT8)
      if (producer && jn < n_tiles) store_mul(jn, ksc, vsc);
  }

  // the output tile through shared memory (Q's space, no longer read),
  // then 16-byte stores; padded query rows hold 0 (l = 0, o = 0)
  const float lc0 = fmaxf(quad_sum(l0), ptt::L_EPS);
  const float lc1 = fmaxf(quad_sum(l1), ptt::L_EPS);
  __syncthreads();
  T* os = reinterpret_cast<T*>(sm + L::Q);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool hi = (i / 2) % 2;
    const float lc = hi ? lc1 : lc0;
    *reinterpret_cast<uint32_t*>(os + (hi ? jr1 : jr0) * L::OSTRIDE +
                                 frag_col(t, i)) =
        pack2<T>(o[i] / lc, o[i + 1] / lc);
  }
  __syncthreads();
  for (int i = tid; i < QT * rep * per_row; i += nt) {
    const int jr = i / per_row, c = i % per_row, qi = q0 + jr / rep;
    if (qi < Qmax)
      *reinterpret_cast<uint4*>(ob + qi * pos_stride + (jr % rep) * HD +
                                c * 8) =
          *reinterpret_cast<const uint4*>(os + jr * L::OSTRIDE + c * 8);
  }
}

// A 4-D map over q [C, Q_max, H, D] (dims D, H, Q_max, C): one box is
// [QT positions][rep heads][64] of one KV group, rows 128 bytes, swizzled
// as make_map's; positions past Q_max are zero-filled.
int make_q_map(CUtensorMap* map, const void* q, int dtype, int D, int H,
               int Qmax, int C, int rep, int QT) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Qmax,
                              (cuuint64_t)C};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)Qmax * H * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rep, (cuuint32_t)QT, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(q), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 4-D map over an int8 page pool [N, page, H_kv, D] (dims D, H_kv, page,
// N): one box is [PB][D] bytes of one KV head, unswizzled.
int make_code_map(CUtensorMap* map, const void* pages, int D, int Hkv,
                  int page, int N, int PB) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)page, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)D, (cuuint64_t)Hkv * D,
                                 (cuuint64_t)page * Hkv * D};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)PB, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<void*>(pages), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *bt, *cl, *ql;
  void* out;
  int C, Qmax, H, Hkv, D, page, P, N;
  float scale;
  int dtype;
  cudaStream_t stream;
};

template <typename T, typename KV, int HD>
int launch(const Args& a) {
  using L = Smem<KV, HD>;
  const int rep = a.H / a.Hkv;
  const int QT = min(BM / rep, a.Qmax);
  int pb_shift = 3;                   // PB = gcd(page, 64), page % 8 == 0
  while (pb_shift < 6 && a.page % (2 << pb_shift) == 0) ++pb_shift;
  CUtensorMap mq, mk, mv;
  int e = make_q_map(&mq, a.q, a.dtype, HD, a.H, a.Qmax, a.C, rep, QT);
  if (!e) {
    if constexpr (L::INT8) {
      e = make_code_map(&mk, a.k, HD, a.Hkv, a.page, a.N, 1 << pb_shift);
      if (!e) e = make_code_map(&mv, a.v, HD, a.Hkv, a.page, a.N,
                                1 << pb_shift);
    } else {
      e = make_map(&mk, a.k, a.dtype, HD, a.Hkv, a.page, a.N, 1 << pb_shift);
      if (!e) e = make_map(&mv, a.v, a.dtype, HD, a.Hkv, a.page, a.N,
                           1 << pb_shift);
    }
  }
  if (e) return e;
  const size_t smem = L::BYTES + 1024;
  auto kern = ragged_sm90_kernel<T, KV, HD>;
  e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  const int ntq = (a.Qmax + QT - 1) / QT;       // query tiles a row
  if ((long long)a.C * ntq > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)a.Hkv, (unsigned)(a.C * ntq));
  kern<<<grid, 128 * NWG, smem, a.stream>>>(
      mq, mk, mv, a.ks, a.vs, a.bt, a.cl, a.ql, (T*)a.out, a.Qmax, a.H,
      a.Hkv, a.page, a.P, QT, ntq, pb_shift, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch_d(const Args& a) {
  return a.D == 64 ? launch<T, KV, 64>(a) : launch<T, KV, 128>(a);
}

template <bool INT8>
int entry(const Args& a) {
  if (a.C <= 0 || a.Qmax <= 0) return 0;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 || a.H / a.Hkv > BM ||
      (a.D != 64 && a.D != 128) || (a.dtype != 1 && a.dtype != 2) ||
      a.page <= 0 || a.page % 8 != 0 || a.P <= 0 || a.N <= 0 ||
      (INT8 && (a.ks == nullptr || a.vs == nullptr)) || !aligned16(a.q) ||
      !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.out))
    return (int)cudaErrorInvalidValue;
  if (a.dtype == 2)
    return INT8 ? launch_d<__half, int8_t>(a) : launch_d<__half, __half>(a);
  return INT8 ? launch_d<__nv_bfloat16, int8_t>(a)
              : launch_d<__nv_bfloat16, __nv_bfloat16>(a);
}

}  // namespace

extern "C" int ptt_ragged_attention_sm90(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, const int* q_lens,
    void* out, int C, int Qmax, int H, int Hkv, int D, int page, int P,
    int N, float scale, int dtype, void* stream) {
  const Args a = {q, k_pages, v_pages, nullptr, nullptr, block_tables,
                  context_lens, q_lens, out, C, Qmax, H, Hkv, D, page, P, N,
                  scale, dtype, (cudaStream_t)stream};
  return entry<false>(a);
}

extern "C" int ptt_ragged_attention_int8_sm90(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* context_lens, const int* q_lens, void* out, int C, int Qmax,
    int H, int Hkv, int D, int page, int P, int N, float scale, int dtype,
    void* stream) {
  const Args a = {q, k_pages, v_pages, k_scales, v_scales, block_tables,
                  context_lens, q_lens, out, C, Qmax, H, Hkv, D, page, P, N,
                  scale, dtype, (cudaStream_t)stream};
  return entry<true>(a);
}
