// The kernels as C++ ops: the forward half of ops/kernels/_ops.py, for a
// process that has no Python interpreter (ptt_run, a C client of the
// predictor API).
//
// TORCH_LIBRARY(ptt) defines the seven forward ops an exported inference
// program can hold, with the schemas that torch.library.custom_op infers
// from _ops.py's annotations (a test holds the two sets equal, string for
// string). An AOTInductor package calls each one by name and overload
// through the dispatcher, so a package compiled in Python runs here
// unchanged. The backward ops are left out: a deployed program holds none.
//
// Each CUDA implementation calls the same extern "C" entry point that the
// Python wrapper calls through ctypes (csrc/<kernel>.cu, built by
// ops/kernels/_build.py; this library links against those libraries), and
// ports the wrapper's host logic: its checks, the output allocation, the
// flash route (bf16/f16 with head dim 64 or 128: the tensor-core kernel,
// else the SIMT one), RoPE's q + k launch and scale = None meaning
// 1/sqrt(D). Inputs are made dense first, as the model code does before it
// calls an op (AOTInductor may hand an op a view). A CPU tensor raises with
// the op's name: nothing falls back to a plain version. Launches go to the
// current stream of the inputs' device.
//
// Launch counts, per op and per route, under the names that
// ops.kernels.launch_counts() gives them, come back as a JSON object from
// ptt_ops_launch_counts.
//
// No CUDA header is needed: the entry points are plain C and the stream
// comes from c10's device-guard interface.

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <optional>
#include <string>
#include <tuple>

extern "C" {
int ptt_rms_norm(const void* x, const void* w, void* out, long long rows,
                 int h, float eps, int x_dtype, int w_dtype, void* stream);
int ptt_swiglu(const void* g, const void* u, void* out, long long n,
               int dtype, void* stream);
int ptt_rope(const void* q, const void* k, void* oq, void* ok,
             const void* cos, const void* sin, long long tokens, int S,
             int hq, int hk, int D, int row_stride, int transpose,
             int x_dtype, int table_dtype, int* vector, void* stream);
int ptt_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int Sq, int Sk,
                                 int H, int Hkv, int D, float scale,
                                 int causal, int dtype, void* stream);
int ptt_flashmask_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D, float scale,
    int causal, int dtype, void* stream);
int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hkv, int D, float scale, int causal,
                            int dtype, void* stream);
int ptt_flashmask_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* start, const void* end, const void* start2, const void* end2,
    int kh, int nm, int B, int Sq, int Sk, int H, int Hkv, int D, float scale,
    int causal, int dtype, void* stream);
int ptt_bias_dropout_residual_ln(
    const void* x, const void* bias, const void* residual, const void* w,
    const void* b, void* out, void* y, void* keep, long long rows, int h,
    float eps, float p, float inv_keep, unsigned int seed, int vec,
    int x_dtype, int w_dtype, void* stream);
}

namespace {

// the counters, named as ops.kernels.launch_counts() names them
enum Counter {
  kRmsNorm, kSwiglu, kRope, kRopeQk, kRopeScalar, kFlash, kFlashSm90,
  kFlashSimt, kMask, kMaskSm90, kMaskSimt, kBdrln, kCounters
};
const char* const kCounterNames[kCounters] = {
    "rms_norm", "swiglu", "fused_rope", "fused_rope.qk", "fused_rope.scalar",
    "flash_attention", "flash_attention.sm90", "flash_attention.simt",
    "flashmask_attention", "flashmask_attention.sm90",
    "flashmask_attention.simt", "bias_dropout_residual_ln"};
std::atomic<long long> g_counts[kCounters];

void count(Counter c) { g_counts[c].fetch_add(1); }

constexpr int kMaxHeadDim = 256;

// dtype codes shared with the C entry points (csrc/common.cuh)
int dtype_code(const at::Tensor& t, const char* what) {
  switch (t.scalar_type()) {
    case at::kFloat: return 0;
    case at::kBFloat16: return 1;
    case at::kHalf: return 2;
    default:
      TORCH_CHECK(false, what, ": CUDA kernels take float32/bfloat16/"
                  "float16, got ", t.scalar_type());
  }
}

// the tensor on the card, dense (a no-op for a contiguous one)
at::Tensor dense(const at::Tensor& t, const at::Tensor& ref,
                 const char* what, const char* name) {
  TORCH_CHECK(t.device() == ref.device(), what, ": ", name, " is on ",
              t.device(), ", expected ", ref.device());
  return t.contiguous();
}

void require_cuda(const at::Tensor& ref, const char* what) {
  TORCH_CHECK(ref.is_cuda(), what, ": tensors on ", ref.device(),
              " take no C++ op (it launches the CUDA kernel only)");
}

void* stream_of(const at::Tensor& t) {
  const c10::impl::VirtualGuardImpl impl(t.device().type());
  return impl.getStream(t.device()).native_handle();
}

void check_rc(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, ": CUDA error ", rc, " at launch");
}

const void* ptr(const at::Tensor& t) { return t.data_ptr(); }
void* mut(at::Tensor& t) { return t.data_ptr(); }

// t itself, or a copy when its data does not start on 16 bytes (the
// tensor-core kernels' TMA maps need 16-byte aligned bases)
at::Tensor aligned(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0 ? t : t.clone();
}

// -- RMSNorm and SwiGLU -----------------------------------------------------

at::Tensor rms_norm(const at::Tensor& x_in, const at::Tensor& w_in,
                    double eps) {
  const char* what = "ptt::rms_norm";
  require_cuda(x_in, what);
  const c10::DeviceGuard guard(x_in.device());
  const at::Tensor x = dense(x_in, x_in, what, "x");
  const at::Tensor w = dense(w_in, x_in, what, "w");
  TORCH_CHECK(x.dim() >= 1, what, ": x must have a last dim");
  const int64_t h = x.size(-1);
  TORCH_CHECK(w.dim() == 1 && w.size(0) == h, what, ": weight shape ",
              w.sizes(), " != (", h, ",)");
  at::Tensor out = at::empty_like(x);
  const long long rows = h ? x.numel() / h : 0;
  check_rc(ptt_rms_norm(ptr(x), ptr(w), mut(out), rows, (int)h, (float)eps,
                        dtype_code(x, what), dtype_code(w, what),
                        stream_of(x)), what);
  count(kRmsNorm);
  return out;
}

at::Tensor swiglu(const at::Tensor& gate_in, const at::Tensor& up_in) {
  const char* what = "ptt::swiglu";
  require_cuda(gate_in, what);
  const c10::DeviceGuard guard(gate_in.device());
  const at::Tensor gate = dense(gate_in, gate_in, what, "gate");
  const at::Tensor up = dense(up_in, gate_in, what, "up");
  TORCH_CHECK(gate.sizes() == up.sizes() &&
              gate.scalar_type() == up.scalar_type(), what, ": gate ",
              gate.sizes(), " ", gate.scalar_type(), " and up ", up.sizes(),
              " ", up.scalar_type(), " must match");
  at::Tensor out = at::empty_like(gate);
  check_rc(ptt_swiglu(ptr(gate), ptr(up), mut(out), gate.numel(),
                      dtype_code(gate, what), stream_of(gate)), what);
  count(kSwiglu);
  return out;
}

// -- RoPE -----------------------------------------------------------------

// rope.py's _check: the table row stride for x [B, S, H, D]: 0 for [S, D]
// tables; with `rows`, S for per-token rows [B, S, D] and 1 for [B, D]
// when S = 1
int rope_row_stride(const char* what, const at::Tensor& x,
                    const at::Tensor& cos, const at::Tensor& sin,
                    const at::Tensor* k, bool rows) {
  TORCH_CHECK(x.dim() == 4, what, ": x must be [B, S, H, D], got ",
              x.sizes());
  const int64_t b = x.size(0), s = x.size(1), d = x.size(3);
  TORCH_CHECK(d % 2 == 0, what, ": the head dim must be even, got ", d);
  TORCH_CHECK(cos.scalar_type() == sin.scalar_type() &&
              cos.sizes() == sin.sizes(), what, ": cos and sin must share "
              "one dtype and shape, got ", cos.scalar_type(), cos.sizes(),
              "/", sin.scalar_type(), sin.sizes());
  if (k != nullptr) {
    TORCH_CHECK(k->scalar_type() == x.scalar_type() && k->dim() == 4 &&
                k->size(0) == b && k->size(1) == s && k->size(3) == d,
                what, ": k ", k->scalar_type(), k->sizes(), " must be [B, "
                "S, Hk, D] of x's type beside ", x.scalar_type(), x.sizes());
    TORCH_CHECK(x.size(2) % k->size(2) == 0, what, ": k's ", k->size(2),
                " heads do not divide q's ", x.size(2));
  }
  if (cos.dim() == 2 && cos.size(0) == s && cos.size(1) == d) return 0;
  if (rows && cos.dim() == 3 && cos.size(0) == b && cos.size(1) == s &&
      cos.size(2) == d)
    return (int)s;
  if (rows && s == 1 && cos.dim() == 2 && cos.size(0) == b &&
      cos.size(1) == d)
    return 1;
  TORCH_CHECK(false, what, ": tables ", cos.sizes(), " do not fit x ",
              x.sizes(), " (need ",
              rows ? "[S, D], [B, S, D] or (S = 1) [B, D]" : "[S, D]", ")");
}

// one launch of csrc/rope.cu over q (and k)
std::tuple<at::Tensor, at::Tensor> rope_launch(const char* what,
                                               const at::Tensor& q,
                                               const at::Tensor* k,
                                               const at::Tensor& cos,
                                               const at::Tensor& sin,
                                               int row_stride) {
  at::Tensor oq = at::empty_like(q);
  at::Tensor ok = k != nullptr ? at::empty_like(*k) : at::Tensor();
  int vec = 0;
  check_rc(ptt_rope(ptr(q), k != nullptr ? ptr(*k) : nullptr, mut(oq),
                    k != nullptr ? mut(ok) : nullptr, ptr(cos), ptr(sin),
                    q.size(0) * q.size(1), (int)q.size(1), (int)q.size(2),
                    k != nullptr ? (int)k->size(2) : 0, (int)q.size(3),
                    row_stride, /*transpose=*/0, dtype_code(q, what),
                    dtype_code(cos, what), &vec, stream_of(q)), what);
  count(kRope);
  if (!vec) count(kRopeScalar);
  return {oq, ok};
}

at::Tensor fused_rope(const at::Tensor& x_in, const at::Tensor& cos_in,
                      const at::Tensor& sin_in) {
  const char* what = "ptt::fused_rope";
  require_cuda(x_in, what);
  const c10::DeviceGuard guard(x_in.device());
  const at::Tensor x = dense(x_in, x_in, what, "x");
  const at::Tensor cos = dense(cos_in, x_in, what, "cos");
  const at::Tensor sin = dense(sin_in, x_in, what, "sin");
  const int row_stride = rope_row_stride(what, x, cos, sin, nullptr, false);
  return std::get<0>(rope_launch(what, x, nullptr, cos, sin, row_stride));
}

std::tuple<at::Tensor, at::Tensor> fused_rope_qk(const at::Tensor& q_in,
                                                 const at::Tensor& k_in,
                                                 const at::Tensor& cos_in,
                                                 const at::Tensor& sin_in) {
  const char* what = "ptt::fused_rope_qk";
  require_cuda(q_in, what);
  const c10::DeviceGuard guard(q_in.device());
  const at::Tensor q = dense(q_in, q_in, what, "q");
  const at::Tensor k = dense(k_in, q_in, what, "k");
  const at::Tensor cos = dense(cos_in, q_in, what, "cos");
  const at::Tensor sin = dense(sin_in, q_in, what, "sin");
  const int row_stride = rope_row_stride(what, q, cos, sin, &k, true);
  auto out = rope_launch(what, q, &k, cos, sin, row_stride);
  count(kRopeQk);
  return out;
}

// -- flash attention ------------------------------------------------------

// flash_attention.py's route: "sm90" for bf16/f16 with head dim 64 or 128
bool sm90_route(const at::Tensor& q) {
  const bool half = q.scalar_type() == at::kBFloat16 ||
                    q.scalar_type() == at::kHalf;
  return half && (q.size(3) == 64 || q.size(3) == 128);
}

void flash_check(const char* what, const at::Tensor& q, const at::Tensor& k,
                 const at::Tensor& v) {
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes(), what,
              ": q ", q.sizes(), ", k ", k.sizes(), ", v ", v.sizes(),
              " are not [B, S, H, D] with k and v alike");
  const int64_t b = q.size(0), h = q.size(2), d = q.size(3);
  TORCH_CHECK(k.size(0) == b && k.size(3) == d && h % k.size(2) == 0, what,
              ": q ", q.sizes(), " and k ", k.sizes(), " disagree (batch, "
              "head dim, or heads not a multiple of the KV heads)");
  TORCH_CHECK(d % 8 == 0 && d <= kMaxHeadDim, what, ": the CUDA kernel "
              "takes head dims that are multiples of 8 up to ", kMaxHeadDim,
              ", got ", d);
  TORCH_CHECK(q.scalar_type() == k.scalar_type() &&
              q.scalar_type() == v.scalar_type(), what, ": q, k and v must "
              "share one dtype, got ", q.scalar_type(), "/",
              k.scalar_type(), "/", v.scalar_type());
}

struct Bounds {
  at::Tensor start, end, start2, end2;
  int kh = 1, intervals = 0;   // intervals 0: no mask
};

// flash_attention.py's _check_bounds
Bounds mask_bounds(const char* what, const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& start, const at::Tensor& end,
                   const std::optional<at::Tensor>& start2,
                   const std::optional<at::Tensor>& end2) {
  TORCH_CHECK(start2.has_value() == end2.has_value(), what,
              ": start2 and end2 must be given together");
  Bounds bd;
  bd.start = dense(start, q, what, "start");
  bd.end = dense(end, q, what, "end");
  bd.intervals = 1;
  if (start2.has_value()) {
    bd.start2 = dense(*start2, q, what, "start2");
    bd.end2 = dense(*end2, q, what, "end2");
    bd.intervals = 2;
  }
  const int64_t b = q.size(0), h = q.size(2), s_k = k.size(1),
                h_kv = k.size(2);
  const int64_t kh = start.dim() == 3 ? start.size(1) : -1;
  const std::pair<const char*, const at::Tensor*> named[] = {
      {"start", &bd.start}, {"end", &bd.end}, {"start2", &bd.start2},
      {"end2", &bd.end2}};
  for (int i = 0; i < 2 * bd.intervals; i++) {
    const at::Tensor& t = *named[i].second;
    TORCH_CHECK(t.scalar_type() == at::kInt && t.dim() == 3 &&
                t.size(0) == b && t.size(1) == kh && t.size(2) == s_k &&
                (kh == 1 || kh == h_kv || kh == h), what, ": ",
                named[i].first, " must be int32 [B, kh, S_k] = [", b, ", 1|",
                h_kv, "|", h, ", ", s_k, "] like start, got ", t.sizes(),
                " ", t.scalar_type());
  }
  bd.kh = (int)kh;
  return bd;
}

std::tuple<at::Tensor, at::Tensor> flash_fwd(const char* what,
                                             const at::Tensor& q_in,
                                             const at::Tensor& k_in,
                                             const at::Tensor& v_in,
                                             bool causal,
                                             std::optional<double> scale,
                                             const Bounds* bounds) {
  at::Tensor q = dense(q_in, q_in, what, "q");
  at::Tensor k = dense(k_in, q_in, what, "k");
  at::Tensor v = dense(v_in, q_in, what, "v");
  flash_check(what, q, k, v);
  const bool sm90 = sm90_route(q);
  if (sm90) {
    q = aligned(q);
    k = aligned(k);
    v = aligned(v);
  }
  const int b = (int)q.size(0), s_q = (int)q.size(1), h = (int)q.size(2),
            d = (int)q.size(3), s_k = (int)k.size(1), h_kv = (int)k.size(2);
  const float sc = scale.has_value() ? (float)*scale
                                     : (float)(1.0 / std::sqrt((double)d));
  at::Tensor out = at::empty(q.sizes(), q.options());
  at::Tensor lse = at::empty({b, h, s_q}, q.options().dtype(at::kFloat));
  const int code = dtype_code(q, what);
  void* stream = stream_of(q);
  int rc;
  if (bounds == nullptr) {
    rc = (sm90 ? ptt_flash_attention_fwd_sm90 : ptt_flash_attention_fwd)(
        ptr(q), ptr(k), ptr(v), mut(out), mut(lse), b, s_q, s_k, h, h_kv, d,
        sc, causal ? 1 : 0, code, stream);
  } else {
    const bool two = bounds->intervals == 2;
    rc = (sm90 ? ptt_flashmask_attention_fwd_sm90
               : ptt_flashmask_attention_fwd)(
        ptr(q), ptr(k), ptr(v), mut(out), mut(lse), ptr(bounds->start),
        ptr(bounds->end), two ? ptr(bounds->start2) : nullptr,
        two ? ptr(bounds->end2) : nullptr, bounds->kh, bounds->intervals, b,
        s_q, s_k, h, h_kv, d, sc, causal ? 1 : 0, code, stream);
  }
  check_rc(rc, what);
  if (bounds == nullptr) {
    count(kFlash);
    count(sm90 ? kFlashSm90 : kFlashSimt);
  } else {
    count(kMask);
    count(sm90 ? kMaskSm90 : kMaskSimt);
  }
  return {out, lse};
}

std::tuple<at::Tensor, at::Tensor> flash_attention_fwd(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    bool causal, std::optional<double> scale) {
  const char* what = "ptt::flash_attention_fwd";
  require_cuda(q, what);
  const c10::DeviceGuard guard(q.device());
  return flash_fwd(what, q, k, v, causal, scale, nullptr);
}

std::tuple<at::Tensor, at::Tensor> flashmask_attention_fwd(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const at::Tensor& start, const at::Tensor& end,
    const std::optional<at::Tensor>& start2,
    const std::optional<at::Tensor>& end2, bool causal,
    std::optional<double> scale) {
  const char* what = "ptt::flashmask_attention_fwd";
  require_cuda(q, what);
  const c10::DeviceGuard guard(q.device());
  const Bounds bounds = mask_bounds(what, q, k, start, end, start2, end2);
  return flash_fwd(what, q, k, v, causal, scale, &bounds);
}

// -- bias + dropout + residual + LayerNorm ---------------------------------

std::tuple<at::Tensor, at::Tensor, at::Tensor> bias_dropout_residual_ln(
    const at::Tensor& x_in, const at::Tensor& residual_in,
    const at::Tensor& ln_w_in, const at::Tensor& ln_b_in,
    const std::optional<at::Tensor>& bias_in, double eps, double p,
    c10::SymInt seed) {
  const char* what = "ptt::bias_dropout_residual_ln";
  TORCH_CHECK(p >= 0.0 && p < 1.0, what, ": p must lie in [0, 1), got ", p);
  require_cuda(x_in, what);
  const c10::DeviceGuard guard(x_in.device());
  const at::Tensor x = dense(x_in, x_in, what, "x");
  const at::Tensor residual = dense(residual_in, x_in, what, "residual");
  const at::Tensor ln_w = dense(ln_w_in, x_in, what, "ln_w");
  const at::Tensor ln_b = dense(ln_b_in, x_in, what, "ln_b");
  const at::Tensor bias = bias_in.has_value()
                              ? dense(*bias_in, x_in, what, "bias")
                              : at::Tensor();
  TORCH_CHECK(x.dim() >= 1, what, ": x must have a last dim");
  const int64_t h = x.size(-1);
  TORCH_CHECK(residual.sizes() == x.sizes() &&
              residual.scalar_type() == x.scalar_type(), what,
              ": residual ", residual.sizes(), " ", residual.scalar_type(),
              " must match x ", x.sizes(), " ", x.scalar_type());
  const std::pair<const char*, const at::Tensor*> params[] = {
      {"ln_w", &ln_w}, {"ln_b", &ln_b}, {"bias", &bias}};
  for (const auto& [name, t] : params) {
    if (!t->defined()) continue;
    TORCH_CHECK(t->dim() == 1 && t->size(0) == h &&
                t->scalar_type() == ln_w.scalar_type(), what, ": ", name,
                " must be [", h, "] of ln_w's dtype ", ln_w.scalar_type(),
                ", got ", t->sizes(), " ", t->scalar_type());
  }
  at::Tensor out = at::empty_like(x);
  at::Tensor y = at::empty_like(x);
  // p == 0: nothing dropped, an empty mask (the Python op's convention)
  const auto bytes = x.options().dtype(at::kByte);
  at::Tensor keep = p > 0.0 ? at::empty(x.sizes(), bytes)
                            : at::empty({0}, bytes);
  bool vec = h % 8 == 0;
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{
           &x, &residual, &out, &y, &ln_w, &ln_b, &bias, &keep}) {
    if (t->defined() && t->numel() > 0)
      vec = vec && reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0;
  }
  const float inv_keep = (float)(1.0 / (1.0 - p));
  const int64_t rows = h ? x.numel() / h : 0;
  check_rc(ptt_bias_dropout_residual_ln(
               ptr(x), bias.defined() ? ptr(bias) : nullptr, ptr(residual),
               ptr(ln_w), ptr(ln_b), mut(out), mut(y),
               p > 0.0 ? mut(keep) : nullptr, rows, (int)h, (float)eps,
               (float)p, inv_keep,
               (unsigned int)(seed.expect_int() & 0xFFFFFFFFLL), vec ? 1 : 0,
               dtype_code(x, what), dtype_code(ln_w, what), stream_of(x)),
           what);
  count(kBdrln);
  return {out, y, keep};
}

// a CPU tensor reaches no kernel: raise with the op's name
void refuse_cpu(const c10::OperatorHandle& op, torch::jit::Stack*) {
  TORCH_CHECK(false, op.schema().name(), ": tensors on cpu take no C++ op "
              "(it launches the CUDA kernel only; the plain versions are "
              "Python's)");
}

}  // namespace

TORCH_LIBRARY(ptt, m) {
  m.def("rms_norm(Tensor x, Tensor w, float eps) -> Tensor");
  m.def("swiglu(Tensor gate, Tensor up) -> Tensor");
  m.def("fused_rope(Tensor x, Tensor cos, Tensor sin) -> Tensor");
  m.def("fused_rope_qk(Tensor q, Tensor k, Tensor cos, Tensor sin) -> "
        "(Tensor, Tensor)");
  m.def("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
        "float? scale) -> (Tensor, Tensor)");
  m.def("flashmask_attention_fwd(Tensor q, Tensor k, Tensor v, "
        "Tensor start, Tensor end, Tensor? start2, Tensor? end2, "
        "bool causal, float? scale) -> (Tensor, Tensor)");
  m.def("bias_dropout_residual_ln(Tensor x, Tensor residual, Tensor ln_w, "
        "Tensor ln_b, Tensor? bias, float eps, float p, SymInt seed) -> "
        "(Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(ptt, CUDA, m) {
  m.impl("rms_norm", &rms_norm);
  m.impl("swiglu", &swiglu);
  m.impl("fused_rope", &fused_rope);
  m.impl("fused_rope_qk", &fused_rope_qk);
  m.impl("flash_attention_fwd", &flash_attention_fwd);
  m.impl("flashmask_attention_fwd", &flashmask_attention_fwd);
  m.impl("bias_dropout_residual_ln", &bias_dropout_residual_ln);
}

TORCH_LIBRARY_IMPL(ptt, CPU, m) {
  for (const char* name : {"rms_norm", "swiglu", "fused_rope",
                           "fused_rope_qk", "flash_attention_fwd",
                           "flashmask_attention_fwd",
                           "bias_dropout_residual_ln"})
    m.impl(name, torch::CppFunction::makeFromBoxedFunction<&refuse_cpu>());
}

extern "C" {

// The launch counts since the last reset as one JSON object; returns the
// length written (at most outlen - 1), or -1 when outlen is too short.
int ptt_ops_launch_counts(char* out, int outlen) {
  std::string s = "{";
  for (int i = 0; i < kCounters; i++) {
    s += (i ? ", \"" : "\"") + std::string(kCounterNames[i]) + "\": " +
         std::to_string(g_counts[i].load());
  }
  s += "}";
  if (out == nullptr || (int)s.size() >= outlen) return -1;
  std::snprintf(out, outlen, "%s", s.c_str());
  return (int)s.size();
}

void ptt_ops_reset_launch_counts() {
  for (auto& c : g_counts) c.store(0);
}

}  // extern "C"
