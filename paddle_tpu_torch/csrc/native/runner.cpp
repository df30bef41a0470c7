// Native deploy runtime: load and run an AOTInductor package (the
// <path>.aoti.pt2 that inference.native.NativePredictor compiles from a
// jit.save artifact) with no Python in the process. The counterpart of
// paddle_tpu/runtime/csrc/pjrt_runner.cc: the JAX package compiles its
// StableHLO program through the PJRT C API, the port loads the package
// through torch::inductor::AOTIModelPackageLoader.
//
// Exposed as a ctypes-friendly C API (ptt_native_*, declared in
// paddle_tpu_torch_c_api.h) that inference/native.py, c_api.cpp and the
// ptt_run CLI (run_main.cpp) use. Errors come back as strings in `err`.
//
// The package calls each kernel as a ptt op through the dispatcher. In a
// Python process the ops are already defined (ops/kernels/_ops.py) and
// the package reaches them; elsewhere the runner loads the C++ op library
// (ops.cpp, libptt_ops.so beside this library) before the loader resolves
// the package's ops. Loading it where Python has defined the ops would
// fail on a duplicate definition, so it is loaded only where
// ptt::rms_norm has no schema.
//
// Host buffers in, host buffers out, with the JAX package's dtype codes
// (paddle_tpu/inference/native.py): 0=f32 1=f64 2=bf16 3=f16 4=s8 5=s16
// 6=s32 7=s64 8=u8 9=u32 10=u64 11=bool. Inputs are copied to the
// package's device and the package runs on that device's current stream,
// the stream the C++ ops launch on; each output is copied back once (a
// sync) into a malloc'd buffer that ptt_native_free_host releases.

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <vector>

// re-declares this file's exports: keeps the public C header from drifting
#include "paddle_tpu_torch_c_api.h"

namespace {

const at::ScalarType kTypes[] = {
    at::kFloat, at::kDouble, at::kBFloat16, at::kHalf,   at::kChar,
    at::kShort, at::kInt,    at::kLong,     at::kByte,   at::kUInt32,
    at::kUInt64, at::kBool};
constexpr int kNumTypes = sizeof(kTypes) / sizeof(kTypes[0]);

struct Runner {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device{c10::kCPU};
  std::string platform;
  int64_t num_inputs = 0;
  int64_t num_outputs = 0;
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err != nullptr && errlen > 0)
    std::snprintf(err, errlen, "%s", msg.c_str());
}

// an error's text without the C++ backtrace that c10 appends (also when
// the AOTInductor runner rethrows it as another exception)
std::string message(const std::exception& e) {
  auto* c = dynamic_cast<const c10::Error*>(&e);
  std::string msg = c != nullptr ? c->what_without_backtrace() : e.what();
  const size_t cut = msg.find("\nException raised from");
  return cut == std::string::npos ? msg : msg.substr(0, cut);
}

// the directory this library (or the executable it is linked into) lives in
std::string own_dir() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&ptt_native_load), &info) == 0 ||
      info.dli_fname == nullptr)
    return ".";
  std::string path(info.dli_fname);
  const size_t slash = path.rfind('/');
  return slash == std::string::npos ? "." : path.substr(0, slash);
}

std::mutex g_ops_mu;
void* g_ops = nullptr;  // the C++ op library, once this runner loaded it

std::string ops_path() { return own_dir() + "/libptt_ops.so"; }

bool file_exists(const std::string& path) {
  std::ifstream f(path);
  return static_cast<bool>(f);
}

// Load the C++ op library unless ptt::rms_norm already has a schema (a
// Python process, or a library loaded before). Returns false (err filled)
// when it exists and fails to load, or when `required` and it is missing.
bool ensure_ops(bool required, char* err, int errlen) {
  std::lock_guard<std::mutex> lock(g_ops_mu);
  if (c10::Dispatcher::singleton().findSchema({"ptt::rms_norm", ""}))
    return true;
  const std::string path = ops_path();
  if (!file_exists(path)) {
    if (required)
      set_err(err, errlen,
              "no ptt op library at " + path +
                  ": it is built beside the runner on a machine with nvcc "
                  "(paddle_tpu_torch.runtime.build(ops=True))");
    return !required;
  }
  g_ops = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (g_ops == nullptr) {
    set_err(err, errlen, std::string("dlopen ") + path + ": " + dlerror());
    return false;
  }
  return true;
}

// leaves of a pytree spec serialized by torch.utils._pytree.treespec_dumps:
// every leaf is written as {"type": null, "context": null, ...}
int64_t spec_leaves(const std::string& spec) {
  int64_t n = 0;
  const std::string leaf = "\"type\": null";
  for (size_t pos = spec.find(leaf); pos != std::string::npos;
       pos = spec.find(leaf, pos + leaf.size()))
    n++;
  return n;
}

void* stream_for(const c10::Device& device) {
  if (!device.is_cuda()) return nullptr;
  const c10::impl::VirtualGuardImpl impl(device.type());
  return impl.getStream(device).native_handle();
}

at::Tensor from_host(const void* data, const int64_t* dims, int rank,
                     int code, const c10::Device& device, int i) {
  TORCH_CHECK(code >= 0 && code < kNumTypes, "input ", i,
              ": unknown dtype code ", code, " (0-", kNumTypes - 1, ")");
  TORCH_CHECK(rank >= 0, "input ", i, ": negative rank ", rank);
  std::vector<int64_t> shape(dims, dims + rank);
  for (int64_t d : shape)
    TORCH_CHECK(d >= 0, "input ", i, ": negative dim in ", shape);
  at::Tensor host = at::from_blob(const_cast<void*>(data), shape,
                                  at::TensorOptions().dtype(kTypes[code]));
  return host.to(device, /*non_blocking=*/false, /*copy=*/true);
}

// each output copied once, straight into its malloc'd buffer (a D2H copy
// for the card's outputs)
int to_host(const std::vector<at::Tensor>& outs, void** out_data,
            int64_t* out_nbytes, int max_out) {
  TORCH_CHECK(static_cast<int64_t>(outs.size()) <= max_out, "the package "
              "gave ", outs.size(), " outputs, room for ", max_out);
  for (size_t i = 0; i < outs.size(); i++) {
    const size_t n = outs[i].nbytes();
    void* p = std::malloc(n ? n : 1);
    TORCH_CHECK(p != nullptr, "out of host memory for output ", i);
    if (n) {
      at::from_blob(p, outs[i].sizes(),
                    at::TensorOptions().dtype(outs[i].scalar_type()))
          .copy_(outs[i]);
    }
    out_data[i] = p;
    out_nbytes[i] = static_cast<int64_t>(n);
  }
  return static_cast<int>(outs.size());
}

// --selftest: a manifest line is `<name> <op> <arg>...`, an arg one of
// t:<dtype>:<rank>:<d0,d1,...>:<file> (a tensor, its bytes in <dir>/<file>),
// f:<float>, b:<0|1>, i:<int> or none
c10::IValue parse_arg(const std::string& dir, const std::string& arg,
                      const c10::Device& device) {
  if (arg == "none") return c10::IValue();
  TORCH_CHECK(arg.size() > 2 && arg[1] == ':', "bad selftest argument '",
              arg, "'");
  const std::string v = arg.substr(2);
  switch (arg[0]) {
    case 'f': return c10::IValue(std::stod(v));
    case 'b': return c10::IValue(v == "1");
    case 'i': return c10::IValue(static_cast<int64_t>(std::stoll(v)));
    case 't': {
      std::vector<std::string> parts;
      std::stringstream ss(v);
      for (std::string p; std::getline(ss, p, ':');) parts.push_back(p);
      TORCH_CHECK(parts.size() == 4, "bad selftest tensor '", arg, "'");
      std::vector<int64_t> dims;
      std::stringstream ds(parts[2]);
      for (std::string d; std::getline(ds, d, ',');)
        if (!d.empty()) dims.push_back(std::stoll(d));
      const int rank = std::stoi(parts[1]);
      TORCH_CHECK(rank == static_cast<int>(dims.size()), "selftest tensor '",
                  arg, "': rank ", rank, " with ", dims.size(), " dims");
      std::ifstream f(dir + "/" + parts[3], std::ios::binary);
      TORCH_CHECK(f, "cannot read ", dir, "/", parts[3]);
      const std::string bytes((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
      at::Tensor t = from_host(bytes.data(), dims.data(), rank,
                               std::stoi(parts[0]), device, 0);
      TORCH_CHECK(static_cast<size_t>(t.nbytes()) == bytes.size(), dir, "/",
                  parts[3], " holds ", bytes.size(), " bytes, the spec ",
                  t.nbytes());
      return c10::IValue(t);
    }
    default:
      TORCH_CHECK(false, "bad selftest argument '", arg, "'");
  }
}

void write_tensor(const std::string& path, const at::Tensor& t) {
  const at::Tensor h = t.contiguous().cpu();
  std::ofstream of(path, std::ios::binary);
  TORCH_CHECK(of, "cannot write ", path);
  of.write(static_cast<const char*>(h.data_ptr()),
           static_cast<std::streamsize>(h.nbytes()));
}

}  // namespace

extern "C" {

void* ptt_native_load(const char* package_path, const char* device,
                      char* err, int errlen) {
  try {
    TORCH_CHECK(package_path != nullptr && file_exists(package_path),
                "cannot read package ",
                package_path ? package_path : "(null)");
    const bool given = device != nullptr && device[0] != '\0';
    const c10::Device want(given ? device : "cpu");
    if (!ensure_ops(given && want.is_cuda(), err, errlen)) return nullptr;
    const c10::DeviceIndex index =
        given && want.has_index() ? want.index() : -1;
    auto r = std::make_unique<Runner>();
    try {
      r->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
          package_path, "model", /*run_single_threaded=*/false,
          /*num_runners=*/1, index);
    } catch (const std::exception& e) {
      const bool ops = static_cast<bool>(
          c10::Dispatcher::singleton().findSchema({"ptt::rms_norm", ""}));
      TORCH_CHECK(false, message(e),
                  ops ? "" : " (no ptt op library is loaded: " + ops_path() +
                                 " is missing)");
    }
    auto meta = r->loader->get_metadata();
    r->platform = meta.count("AOTI_DEVICE_KEY") ? meta["AOTI_DEVICE_KEY"]
                                                : std::string("cpu");
    TORCH_CHECK(!given ||
                    r->platform == c10::DeviceTypeName(want.type(), true),
                "package ", package_path, " was compiled for ", r->platform,
                ", asked to run on ", device);
    r->device = c10::Device(r->platform);
    if (r->device.is_cuda())
      r->device = c10::Device(c10::kCUDA, index >= 0 ? index : 0);
    const auto spec = r->loader->get_call_spec();
    TORCH_CHECK(spec.size() == 2, "package ", package_path,
                " has no call spec");
    r->num_inputs = spec_leaves(spec[0]);
    r->num_outputs = spec_leaves(spec[1]);
    return r.release();
  } catch (const std::exception& e) {
    set_err(err, errlen, message(e));
  }
  return nullptr;
}

int ptt_native_platform(void* runner, char* out, int outlen) {
  const auto* r = static_cast<Runner*>(runner);
  std::snprintf(out, outlen, "%s", r->platform.c_str());
  return 0;
}

int64_t ptt_native_num_outputs(void* runner) {
  return static_cast<Runner*>(runner)->num_outputs;
}

int ptt_native_execute(void* runner, int n_in, const void** in_data,
                       const int64_t* dims_flat, const int* ranks,
                       const int* dtypes, void** out_data,
                       int64_t* out_nbytes, int max_out, char* err,
                       int errlen) {
  try {
    auto* r = static_cast<Runner*>(runner);
    TORCH_CHECK(n_in == r->num_inputs, "the package takes ", r->num_inputs,
                " inputs, got ", n_in);
    const c10::DeviceGuard guard(r->device);
    std::vector<at::Tensor> inputs;
    size_t off = 0;
    for (int i = 0; i < n_in; i++) {
      inputs.push_back(from_host(in_data[i], dims_flat + off, ranks[i],
                                 dtypes[i], r->device, i));
      off += ranks[i];
    }
    const auto outs = r->loader->run(inputs, stream_for(r->device));
    return to_host(outs, out_data, out_nbytes, max_out);
  } catch (const std::exception& e) {
    set_err(err, errlen, message(e));
  }
  return -1;
}

void ptt_native_free_host(void* p) { std::free(p); }

void ptt_native_destroy(void* runner) { delete static_cast<Runner*>(runner); }

int ptt_native_launch_counts(char* out, int outlen) {
  using Fn = int (*)(char*, int);
  auto fn = g_ops == nullptr ? nullptr : reinterpret_cast<Fn>(
      dlsym(g_ops, "ptt_ops_launch_counts"));
  return fn == nullptr ? -1 : fn(out, outlen);
}

void ptt_native_reset_launch_counts() {
  using Fn = void (*)();
  auto fn = g_ops == nullptr ? nullptr : reinterpret_cast<Fn>(
      dlsym(g_ops, "ptt_ops_reset_launch_counts"));
  if (fn != nullptr) fn();
}

int ptt_native_selftest(const char* dir, char* err, int errlen) {
  try {
    if (!ensure_ops(true, err, errlen)) return -1;
    const std::string root(dir);
    std::ifstream manifest(root + "/calls.txt");
    TORCH_CHECK(manifest, "cannot read ", root, "/calls.txt");
    const c10::Device device(c10::kCUDA, 0);
    const c10::DeviceGuard guard(device);
    int calls = 0;
    for (std::string line; std::getline(manifest, line);) {
      std::stringstream ss(line);
      std::string name, op;
      if (!(ss >> name >> op)) continue;
      const auto handle = c10::Dispatcher::singleton().findSchemaOrThrow(
          ("ptt::" + op).c_str(), "");
      torch::jit::Stack stack;
      for (std::string arg; ss >> arg;)
        stack.push_back(parse_arg(root, arg, device));
      handle.callBoxed(&stack);
      for (size_t i = 0; i < stack.size(); i++)
        write_tensor(root + "/" + name + ".out" + std::to_string(i) + ".bin",
                     stack[i].toTensor());
      calls++;
    }
    return calls;
  } catch (const std::exception& e) {
    set_err(err, errlen, message(e));
  }
  return -1;
}

}  // extern "C"
