/* A plain C client of the port's predictor API: serve a jit.save
 * artifact's AOTInductor package (<prefix>.aoti.pt2, compiled once by
 * paddle_tpu_torch.inference.native.NativePredictor) with no Python in
 * the process.
 *
 *   gcc -x c examples/ptt_c_client.c -I paddle_tpu_torch/csrc/native \
 *       <build dir>/libptt_native.so -Wl,-rpath,<build dir> -o client
 *   ./client <prefix> <device> <dtype> <input.bin> <d0> [d1 ...]
 *
 * (<build dir>: paddle_tpu_torch.runtime.paths()["dir"].) device is
 * "cuda", "cuda:<i>" or "cpu"; dtype a code of paddle_tpu_torch_c_api.h.
 * The one input is read from input.bin; output i is written to
 * c_out_<i>.bin in the working directory.
 */
#include <stdio.h>
#include <stdlib.h>

#include "paddle_tpu_torch_c_api.h"

#define MAX_RANK 8
#define MAX_OUT 16

static const int kItemBytes[] = {4, 8, 2, 2, 1, 2, 4, 8, 1, 4, 8, 1};

int main(int argc, char** argv) {
  if (argc < 6 || argc - 5 > MAX_RANK) {
    fprintf(stderr, "usage: %s <prefix> <device> <dtype> <input.bin> "
            "<d0> [d1 ...]\n", argv[0]);
    return 2;
  }
  int dtype = atoi(argv[3]);
  if (dtype < 0 || dtype > 11) {
    fprintf(stderr, "unknown dtype code %d\n", dtype);
    return 2;
  }
  int rank = argc - 5;
  int64_t dims[MAX_RANK];
  long long n = kItemBytes[dtype];
  for (int i = 0; i < rank; i++) {
    dims[i] = atoll(argv[5 + i]);
    n *= dims[i];
  }
  FILE* f = fopen(argv[4], "rb");
  if (!f) { fprintf(stderr, "cannot read %s\n", argv[4]); return 2; }
  void* x = malloc(n ? n : 1);
  long long got = (long long)fread(x, 1, (size_t)n, f);
  fclose(f);
  if (got != n) {
    fprintf(stderr, "%s holds fewer than %lld bytes\n", argv[4], n);
    return 2;
  }

  char err[4096] = {0};
  void* pred = ptt_predictor_create(argv[1], argv[2], err, sizeof(err));
  if (!pred) { fprintf(stderr, "create: %s\n", err); return 1; }
  char plat[64] = {0};
  ptt_predictor_platform(pred, plat, sizeof(plat));
  printf("platform=%s outputs=%lld\n", plat,
         (long long)ptt_predictor_num_outputs(pred));

  const void* ins[1] = {x};
  int ranks[1] = {rank};
  int dtypes[1] = {dtype};
  void* outs[MAX_OUT] = {0};
  int64_t sizes[MAX_OUT] = {0};
  int k = ptt_predictor_run(pred, 1, ins, dims, ranks, dtypes, outs, sizes,
                            MAX_OUT, err, sizeof(err));
  if (k < 0) { fprintf(stderr, "run: %s\n", err); return 1; }
  for (int i = 0; i < k; i++) {
    char name[32];
    snprintf(name, sizeof(name), "c_out_%d.bin", i);
    FILE* o = fopen(name, "wb");
    fwrite(outs[i], 1, (size_t)sizes[i], o);
    fclose(o);
    printf("wrote %s: %lld bytes\n", name, (long long)sizes[i]);
    ptt_native_free_host(outs[i]);
  }
  ptt_predictor_destroy(pred);
  free(x);
  return 0;
}
