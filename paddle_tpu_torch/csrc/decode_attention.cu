// Paged decode attention over float page pools (pages in q's type): the C
// entry of the kernel in decode_attention.cuh, where its shapes, bound and
// design are described, and the split plan that sizes its workspace.
#include "decode_attention.cuh"

extern "C" int ptt_decode_attention(const void* q, const void* k_pages,
                                    const void* v_pages, const int* block_tables,
                                    const int* context_lens, void* out,
                                    void* ws, int B, int H, int Hkv, int D,
                                    int page, int P, float scale, int dtype,
                                    void* stream) {
  int rc = 0;
  PTT_DISPATCH(dtype, T, rc = ptt::launch_decode<T, T>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens, out,
      (float*)ws, B, H, Hkv, D, page, P, scale, (cudaStream_t)stream))
  return rc;
}

// plan[0] = splits, plan[1] = pages per split (host only; no device access)
extern "C" void ptt_decode_split_plan(int B, int H, int Hkv, int P, int page,
                                      int* plan) {
  ptt::decode_split_plan(B, H, Hkv, P, page, &plan[0], &plan[1]);
}
