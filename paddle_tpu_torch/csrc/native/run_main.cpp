// ptt_run -- the standalone CLI of the native deploy runtime, with no
// Python in the process: the counterpart of
// paddle_tpu/runtime/csrc/pjrt_run_main.cc.
//
//   ptt_run [--runs N] <package.pt2> [dtype:rank:d0,d1,...:input.bin ...]
//   ptt_run --selftest <dir>
//
// Runs the AOTInductor package (a jit.save artifact's <prefix>.aoti.pt2)
// on the device it was compiled for, N times (default 1), writes each
// output of the last run to out_<i>.bin in the CWD and prints a one-line
// summary per output. On stderr: the platform, the load's and each run's
// seconds, and the C++ ops' launches in the last run ("launches: {...}",
// or "launches: none" where no C++ op library was loaded). dtype codes:
// 0=f32 1=f64 2=bf16 3=f16 4=s8 5=s16 6=s32 7=s64 8=u8 9=u32 10=u64
// 11=bool.
//
// --selftest calls each op that <dir>/calls.txt lists once, through the
// dispatcher, on the inputs <dir> holds, and writes the outputs there
// (ptt_native_selftest).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include "paddle_tpu_torch_c_api.h"

namespace {

const int kItemBytes[] = {4, 8, 2, 2, 1, 2, 4, 8, 1, 4, 8, 1};
constexpr int kNumTypes = sizeof(kItemBytes) / sizeof(kItemBytes[0]);

bool read_file(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  *out = ss.str();
  return true;
}

bool whole_number(const std::string& s, long long* v) {
  if (s.empty()) return false;
  char* end = nullptr;
  *v = std::strtoll(s.c_str(), &end, 10);
  return *end == '\0';
}

struct Input {
  std::string bytes;
  int dtype = 0;
  std::vector<int64_t> dims;
};

// dtype:rank:d0,d1,...:file -> Input, or an error message
std::string parse_spec(const std::string& spec, Input* in) {
  const std::string bad = "bad input spec '" + spec +
                          "': expected dtype:rank:d0,d1,...:file";
  const size_t p1 = spec.find(':');
  const size_t p2 = p1 == std::string::npos ? p1 : spec.find(':', p1 + 1);
  const size_t p3 = p2 == std::string::npos ? p2 : spec.find(':', p2 + 1);
  if (p3 == std::string::npos) return bad;
  long long dtype = 0, rank = 0;
  if (!whole_number(spec.substr(0, p1), &dtype) ||
      !whole_number(spec.substr(p1 + 1, p2 - p1 - 1), &rank))
    return bad;
  if (dtype < 0 || dtype >= kNumTypes)
    return bad + " (unknown dtype code " + std::to_string(dtype) + ")";
  std::stringstream dss(spec.substr(p2 + 1, p3 - p2 - 1));
  for (std::string tok; std::getline(dss, tok, ',');) {
    long long d = 0;
    if (!whole_number(tok, &d) || d < 0) return bad;
    in->dims.push_back(d);
  }
  if (rank != static_cast<long long>(in->dims.size()))
    return bad + " (rank " + std::to_string(rank) + " with " +
           std::to_string(in->dims.size()) + " dims)";
  const std::string file = spec.substr(p3 + 1);
  if (!read_file(file, &in->bytes)) return "cannot read " + file;
  long long n = kItemBytes[dtype];
  for (int64_t d : in->dims) n *= d;
  if (n != static_cast<long long>(in->bytes.size()))
    return file + " holds " + std::to_string(in->bytes.size()) +
           " bytes, the spec " + std::to_string(n);
  in->dtype = static_cast<int>(dtype);
  return "";
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

void print_launches() {
  char counts[4096] = {0};
  if (ptt_native_launch_counts(counts, sizeof(counts)) < 0)
    std::fprintf(stderr, "launches: none\n");
  else
    std::fprintf(stderr, "launches: %s\n", counts);
}

int usage(const char* argv0) {
  std::fprintf(stderr,
               "usage: %s [--runs N] <package.pt2> "
               "[dtype:rank:d0,d1,...:input.bin ...]\n"
               "       %s --selftest <dir>\n",
               argv0, argv0);
  return 2;
}

int selftest(const char* dir) {
  char err[4096] = {0};
  ptt_native_reset_launch_counts();
  const int n = ptt_native_selftest(dir, err, sizeof(err));
  if (n < 0) {
    std::fprintf(stderr, "selftest: %s\n", err);
    return 1;
  }
  std::printf("selftest: %d calls\n", n);
  print_launches();
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 3 && std::strcmp(argv[1], "--selftest") == 0)
    return selftest(argv[2]);
  int first = 1;
  long long runs = 1;
  if (argc > 2 && std::strcmp(argv[1], "--runs") == 0) {
    if (!whole_number(argv[2], &runs) || runs < 1) return usage(argv[0]);
    first = 3;
  }
  if (argc <= first || argv[first][0] == '-') return usage(argv[0]);

  std::vector<Input> inputs(argc - first - 1);
  for (int i = first + 1; i < argc; i++) {
    const std::string msg = parse_spec(argv[i], &inputs[i - first - 1]);
    if (!msg.empty()) {
      std::fprintf(stderr, "%s\n", msg.c_str());
      return 2;
    }
  }
  std::vector<const void*> data;
  std::vector<int64_t> dims;
  std::vector<int> ranks, dtypes;
  for (const Input& in : inputs) {
    data.push_back(in.bytes.data());
    dims.insert(dims.end(), in.dims.begin(), in.dims.end());
    ranks.push_back(static_cast<int>(in.dims.size()));
    dtypes.push_back(in.dtype);
  }

  char err[4096] = {0};
  auto t0 = std::chrono::steady_clock::now();
  void* runner = ptt_native_load(argv[first], nullptr, err, sizeof(err));
  if (runner == nullptr) {
    std::fprintf(stderr, "load: %s\n", err);
    return 1;
  }
  char plat[64] = {0};
  ptt_native_platform(runner, plat, sizeof(plat));
  std::fprintf(stderr, "platform: %s\nload_s: %.6f\n", plat,
               seconds_since(t0));

  const int max_out = 64;
  std::vector<void*> outs(max_out, nullptr);
  std::vector<int64_t> sizes(max_out, 0);
  int n = 0;
  for (long long r = 0; r < runs; r++) {
    for (int i = 0; i < n; i++) ptt_native_free_host(outs[i]);
    ptt_native_reset_launch_counts();
    t0 = std::chrono::steady_clock::now();
    n = ptt_native_execute(runner, static_cast<int>(data.size()),
                           data.data(), dims.data(), ranks.data(),
                           dtypes.data(), outs.data(), sizes.data(), max_out,
                           err, sizeof(err));
    if (n < 0) {
      std::fprintf(stderr, "execute: %s\n", err);
      ptt_native_destroy(runner);
      return 1;
    }
    std::fprintf(stderr, "run_s: %.6f\n", seconds_since(t0));
  }
  print_launches();
  for (int i = 0; i < n; i++) {
    char name[32];
    std::snprintf(name, sizeof(name), "out_%d.bin", i);
    std::ofstream of(name, std::ios::binary);
    of.write(static_cast<const char*>(outs[i]), sizes[i]);
    std::printf("out_%d.bin %lld bytes\n", i,
                static_cast<long long>(sizes[i]));
    ptt_native_free_host(outs[i]);
  }
  ptt_native_destroy(runner);
  return 0;
}
