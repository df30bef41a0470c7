"""Build and load the CUDA kernels under ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/kernels/`` at the repository
root (listed in ``.gitignore``), then loaded with ``ctypes``. The library
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads in place. ``build_all`` starts one
``nvcc`` per source, all at once, so a cold start pays for the slowest
file rather than the sum. Nothing is built at import time: the first
launch of a kernel builds it (``load``).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into a RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
SOURCES = ("rms_norm", "swiglu", "decode_attention", "ragged_attention",
           "flash_attention", "rope", "quantized_attention",
           "flash_attention_bwd", "bias_dropout_residual_ln",
           "flash_fwd_sm90", "flash_bwd_sm90", "ragged_sm90")

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or under "
                       f"{home}); the CUDA kernels cannot be built")


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name):
    """Start nvcc for one source; returns (proc, tmp, out, log) or None
    when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=log,
                                stderr=subprocess.STDOUT)
    except OSError:
        log.close()
        raise
    return proc, tmp, out, log


def _finish(name, job):
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (BUILD_DIR / f"{name}.log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {rc}):\n"
                           f"{text[-4000:]}")
    os.replace(tmp, out)


def build_all(names=SOURCES):
    """Compile every listed source in parallel (one nvcc each) and load
    the libraries. Returns {name: seconds its nvcc ran} (0 for a library
    already built)."""
    t0 = time.perf_counter()
    jobs = {}
    waited = {}
    try:
        for n in names:
            jobs[n] = _start(n)
            if jobs[n] is None:
                waited[n] = 0.0
        while any(job is not None for job in jobs.values()):
            for n, job in jobs.items():
                if job is not None and job[0].poll() is not None:
                    _finish(n, job)
                    jobs[n] = None
                    waited[n] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for job in jobs.values():       # a failed build stops the others
            if job is not None:
                job[0].kill()
                job[0].wait()
                job[3].close()
    for n in names:
        load(n)
    return waited


def ptxas_report(name):
    """What ``-Xptxas -v`` printed for the last build of `name`
    (registers, shared memory, spills), or '' when it was not built in
    this checkout."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_target(name)[1]))
            _LIBS[name] = lib
    return lib


def function(name, symbol, argtypes):
    """The C entry `symbol` of ``csrc/<name>.cu`` with its argument types
    declared (pointers and the stream as c_void_p, so ctypes never cuts
    them to 32 bits) and an int return: the cudaGetLastError() code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


# dtype codes shared with the C entry points (csrc/common.cuh)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}


def dtype_code(t):
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32/bfloat16/float16, got "
                        f"{t.dtype}")
    return code


def require_cuda(ref, what, **tensors):
    """Raise unless every named tensor is a contiguous tensor on `ref`'s
    CUDA device: the kernels index raw pointers with packed strides."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {ref.device} take neither the "
                         "CUDA kernel nor the plain (CPU) version")
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t):
    """A tensor's pointer, or NULL for None (an optional workspace)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
