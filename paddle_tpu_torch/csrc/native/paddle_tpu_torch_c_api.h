/* paddle_tpu_torch C inference API: the counterpart of
 * paddle_tpu/runtime/csrc/paddle_tpu_c_api.h (the reference's
 * PD_Predictor* surface, paddle/fluid/inference/capi_exp/).
 *
 * Two altitudes, both exported by libptt_native.so:
 *
 * 1. ptt_predictor_* -- open the AOTInductor package of a jit.save
 *    artifact (<prefix>.aoti.pt2, compiled once by
 *    paddle_tpu_torch.inference.native.NativePredictor) and run inference
 *    from plain C, with no Python in the process.
 * 2. ptt_native_* -- the building blocks the predictor is made of (an
 *    explicit package path, buffer dtypes and dims), the C++ ops' launch
 *    counts and the ops' self-test.
 *
 * device: "cuda", "cuda:<i>" or "cpu"; NULL or "" takes the device the
 * package was compiled for. On the card the kernels run as the C++ ops of
 * libptt_ops.so, which the runner loads from its own directory where no
 * ptt op is defined yet.
 *
 * Memory contract: output buffers are malloc'd by the library and MUST be
 * released with ptt_native_free_host(). All functions are
 * thread-compatible (external synchronization per handle).
 *
 * dtype codes (those of paddle_tpu/inference/native.py _DTYPE_CODES):
 *   0=f32 1=f64 2=bf16 3=f16 4=s8 5=s16 6=s32 7=s64 8=u8 9=u32 10=u64
 *   11=bool
 */

#ifndef PADDLE_TPU_TORCH_C_API_H_
#define PADDLE_TPU_TORCH_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- low-level runner ------------------------------------------------- */

/* Load an AOTInductor package (.pt2) onto device. NULL on error (err
 * filled). */
void* ptt_native_load(const char* package_path, const char* device,
                      char* err, int errlen);

/* Platform of the package ("cuda", "cpu"). */
int ptt_native_platform(void* runner, char* out, int outlen);

int64_t ptt_native_num_outputs(void* runner);

/* Execute with n_in dense row-major host inputs. dims_flat packs each
 * input's dims back-to-back (ranks[i] entries each); dtypes use the
 * codes above. Writes up to max_out malloc'd host buffers + byte sizes;
 * returns the number of outputs, or -1 (err filled). */
int ptt_native_execute(void* runner, int n_in, const void** in_data,
                       const int64_t* dims_flat, const int* ranks,
                       const int* dtypes, void** out_data,
                       int64_t* out_nbytes, int max_out, char* err,
                       int errlen);

void ptt_native_free_host(void* p);
void ptt_native_destroy(void* runner);

/* The C++ ops' launches since the last reset, per op and route, as one
 * JSON object; the length written, or -1 when this runner loaded no C++
 * op library (a Python process runs the Python ops) or outlen is too
 * short. */
int ptt_native_launch_counts(char* out, int outlen);
void ptt_native_reset_launch_counts(void);

/* Call ptt ops through the dispatcher on the card, as <dir>/calls.txt
 * lists them (one call a line: <name> <op> <arg>..., an arg
 * t:<dtype>:<rank>:<d0,d1,...>:<file>, f:<float>, b:<0|1>, i:<int> or
 * none), writing output j of call <name> to <dir>/<name>.out<j>.bin.
 * Returns the number of calls, or -1 (err filled). */
int ptt_native_selftest(const char* dir, char* err, int errlen);

/* ---- predictor-level API (PD_Predictor analog) ------------------------ */

/* Create a predictor from a jit.save artifact prefix: opens
 * <prefix>.aoti.pt2 on device. NULL on error (err filled). */
void* ptt_predictor_create(const char* artifact_prefix, const char* device,
                           char* err, int errlen);

int64_t ptt_predictor_num_outputs(void* predictor);
int ptt_predictor_platform(void* predictor, char* out, int outlen);

/* Run inference; same buffer conventions as ptt_native_execute. */
int ptt_predictor_run(void* predictor, int n_in, const void** in_data,
                      const int64_t* dims_flat, const int* ranks,
                      const int* dtypes, void** out_data,
                      int64_t* out_nbytes, int max_out, char* err,
                      int errlen);

void ptt_predictor_destroy(void* predictor);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_TORCH_C_API_H_ */
