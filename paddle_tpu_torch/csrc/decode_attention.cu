// Paged decode attention over float page pools (pages in q's type): the C
// entry of the kernel in decode_attention.cuh, where its shapes, bound and
// design are described.
#include "decode_attention.cuh"

extern "C" int ptt_decode_attention(const void* q, const void* k_pages,
                                    const void* v_pages, const int* block_tables,
                                    const int* context_lens, void* out, int B,
                                    int H, int Hkv, int D, int page, int P,
                                    float scale, int dtype, void* stream) {
  int rc = 0;
  PTT_DISPATCH(dtype, T, rc = ptt::launch_decode<T, T>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, context_lens, out,
      B, H, Hkv, D, page, P, scale, (cudaStream_t)stream))
  return rc;
}
