// The range mask of flashmask attention, shared by the forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels.
//
// A launch carries NM (0, 1 or 2) intervals of masked query rows per key:
// bounds [B, kh, S_k] int32, kh 1, H_kv or H. Query row i (in query-row
// coordinates) cannot see key t when start[t] <= i < end[t] or, with two
// intervals, start2[t] <= i < end2[t] -- the predicate of the TPU kernels'
// _range_mask (paddle_tpu/ops/pallas/flash_attention.py). A block stages
// the bounds of its key tile in shared memory; NM is a template argument
// of the kernels, and with NM = 0 every helper here compiles away.
#pragma once

#include <stdint.h>

namespace ptt {

struct Bounds {
  const int* start;
  const int* end;
  const int* start2;
  const int* end2;
  int kh;
};

// Stages keys [k0, k0 + n) of the bound row at offset `row` into
// bs[2 * NM][n] (start, end, start2, end2), zeros past Sk.
template <int NM>
__device__ __forceinline__ void stage_bounds(int* bs, const Bounds& mb,
                                             int64_t row, int k0, int n,
                                             int Sk) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int kp = k0 + t;
    const bool in = kp < Sk;
    bs[t] = in ? mb.start[row + kp] : 0;
    bs[n + t] = in ? mb.end[row + kp] : 0;
    if (NM == 2) {
      bs[2 * n + t] = in ? mb.start2[row + kp] : 0;
      bs[3 * n + t] = in ? mb.end2[row + kp] : 0;
    }
  }
}

// True unless query row qi lies in one of staged key t's masked intervals.
template <int NM>
__device__ __forceinline__ bool range_visible(const int* bs, int n, int t,
                                              int qi) {
  if (NM == 0) return true;
  bool masked = bs[t] <= qi && qi < bs[n + t];
  if (NM == 2) masked = masked || (bs[2 * n + t] <= qi && qi < bs[3 * n + t]);
  return !masked;
}

// Offset of query head h's bound row (KV group g) in [B, kh, Sk].
__device__ __forceinline__ int64_t bound_row(const Bounds& mb, int b, int h,
                                             int g, int H, int Sk) {
  const int mh = mb.kh == 1 ? 0 : (mb.kh == H ? h : g);
  return ((int64_t)b * mb.kh + mh) * Sk;
}

// The launch check of the C entries: nm in {0, 1, 2}, kh in {1, H_kv, H}.
inline bool bounds_ok(const Bounds& mb, int nm, int H, int Hkv) {
  return nm >= 0 && nm <= 2 &&
         (nm == 0 || mb.kh == 1 || mb.kh == H || mb.kh == Hkv);
}

}  // namespace ptt
