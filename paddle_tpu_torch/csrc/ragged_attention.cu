// Ragged paged attention over float page pools (pages in q's type): the C
// entry of the kernel in ragged_attention.cuh, where its shapes, bound and
// design are described.
#include "ragged_attention.cuh"

extern "C" int ptt_ragged_attention(const void* q, const void* k_pages,
                                    const void* v_pages, const int* block_tables,
                                    const int* context_lens, const int* q_lens,
                                    void* out, int C, int Qmax, int H, int Hkv,
                                    int D, int page, int P, int QT, float scale,
                                    int dtype, void* stream) {
  int rc = 0;
  PTT_DISPATCH(dtype, T, rc = ptt::launch_ragged<T, T>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens,
      q_lens, out, C, Qmax, H, Hkv, D, page, P, QT, scale,
      (cudaStream_t)stream))
  return rc;
}
