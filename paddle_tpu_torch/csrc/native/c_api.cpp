// Predictor-level C API (ref: fluid/inference/capi_exp/pd_inference_api.h
// PD_PredictorCreate/Run) over the ptt_native_* runner: the counterpart
// of paddle_tpu/runtime/csrc/c_api.cc. A predictor is the runner of the
// artifact's AOTInductor package, <prefix>.aoti.pt2 (compiled once by
// paddle_tpu_torch.inference.native.NativePredictor), served entirely
// from C.

#include <cstdint>
#include <string>

#include "paddle_tpu_torch_c_api.h"

extern "C" {

void* ptt_predictor_create(const char* artifact_prefix, const char* device,
                           char* err, int errlen) {
  const std::string package = std::string(artifact_prefix) + ".aoti.pt2";
  return ptt_native_load(package.c_str(), device, err, errlen);
}

int64_t ptt_predictor_num_outputs(void* predictor) {
  return ptt_native_num_outputs(predictor);
}

int ptt_predictor_platform(void* predictor, char* out, int outlen) {
  return ptt_native_platform(predictor, out, outlen);
}

int ptt_predictor_run(void* predictor, int n_in, const void** in_data,
                      const int64_t* dims_flat, const int* ranks,
                      const int* dtypes, void** out_data,
                      int64_t* out_nbytes, int max_out, char* err,
                      int errlen) {
  return ptt_native_execute(predictor, n_in, in_data, dims_flat, ranks,
                            dtypes, out_data, out_nbytes, max_out, err,
                            errlen);
}

void ptt_predictor_destroy(void* predictor) { ptt_native_destroy(predictor); }

}  // extern "C"
