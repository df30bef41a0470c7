// Dequant-fused paged attention over int8 KV pages: the C entries of the
// decode and ragged kernels (decode_attention.cuh, ragged_attention.cuh)
// instantiated with int8 pages and per-page float32 scales.
//
//   k/v pages  [N, page, H_kv, D] int8 codes in [-127, 127]
//   k/v scales [N] float32, this layer's per-page scale rows
//   q, out     in the storage type named by `dtype` (common.cuh)
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/quantized_attention.py:
// _decode_int8_kernel (paged_decode_attention_int8, pallas_call :213) and
// _ragged_int8_kernel (ragged_paged_attention_int8, pallas_call :331).
// The ragged kernel dequantizes each page as it stages it in shared memory,
// code * (scale[pid] * (1/127)); the decode kernel folds the two per-page
// multipliers into the page's scores and probabilities (see
// decode_attention.cuh). A float pool never exists. What bounds them on
// the H100: memory for decode (the int8 context, half the bf16 bytes, plus
// q, out and the scales), operations for long prefill rows, as their float
// twins. Masking, the online softmax and the finalize are the float
// kernels' own. The decode entry takes the float entry's workspace (sized
// by the same split plan).
#include "decode_attention.cuh"
#include "ragged_attention.cuh"

extern "C" int ptt_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* context_lens, void* out, void* ws, int B, int H, int Hkv,
    int D, int page, int P, float scale, int dtype, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  PTT_DISPATCH(dtype, T, rc = ptt::launch_decode<T, int8_t>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
      out, (float*)ws, B, H, Hkv, D, page, P, scale, (cudaStream_t)stream))
  return rc;
}

extern "C" int ptt_ragged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* context_lens, const int* q_lens, void* out, int C, int Qmax,
    int H, int Hkv, int D, int page, int P, int QT, float scale, int dtype,
    void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  PTT_DISPATCH(dtype, T, rc = ptt::launch_ragged<T, int8_t>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
      q_lens, out, C, Qmax, H, Hkv, D, page, P, QT, scale,
      (cudaStream_t)stream))
  return rc;
}
