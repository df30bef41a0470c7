"""The native deploy runtime: the counterpart of the deploy half of
``paddle_tpu/runtime/__init__.py`` (``_needs_build``, ``_build_pjrt``,
``get_pjrt_lib``).

Its sources are ``paddle_tpu_torch/csrc/native``: ``runner.cpp`` (load
and run an AOTInductor package through
``torch::inductor::AOTIModelPackageLoader``, host buffers in and out),
``c_api.cpp`` with ``paddle_tpu_torch_c_api.h`` (the predictor C API),
``run_main.cpp`` (the ``ptt_run`` CLI) and ``ops.cpp`` (the kernels as C++
``ptt`` ops, for a process without Python). ``build`` compiles them with a
C++ compiler against torch's headers and libraries into
``build/native/<key>/`` at the repository root (under ``.gitignore``'s
``/build/``): ``libptt_native.so`` (runner and C API), ``ptt_run`` and,
where ``nvcc`` is, ``libptt_ops.so``, linked against the kernel libraries
that ``ops.kernels._build`` builds. The key hashes the sources, the flags,
torch's version and the names of those kernel libraries (which carry
their own sources' hashes), so an edit builds into a new directory and an
unchanged tree reuses the old one. The runner, the C API and ``ptt_run``
need no CUDA toolkit; every process ``build`` starts runs at once, so a
cold build takes the slowest compile, not the sum.

``get_native_lib`` loads the runner with ``ctypes.CDLL``, which releases
the GIL during a call: a ``ptt`` op implemented in Python, which the
package calls back in-process, takes it again.

The JAX runtime's shared-memory ring has no counterpart (the port's
``DataLoader`` moves batches through torch's shared memory); its
``TCPStore`` belongs to the multi-host work.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
HEADER = "paddle_tpu_torch_c_api.h"
SOURCES = ("runner.cpp", "c_api.cpp", "run_main.cpp", "ops.cpp", HEADER)
LIB = "libptt_native.so"
RUN = "ptt_run"
OPS = "libptt_ops.so"
# the kernel libraries of ops.cpp's seven ops (csrc/<name>.cu)
OPS_KERNELS = ("rms_norm", "swiglu", "rope", "flash_attention",
               "flash_fwd_sm90", "bias_dropout_residual_ln")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++20"]

_LOCK = threading.Lock()
_LIB = None
_PENDING = {}       # build dir -> the state of a build this process started


def openmp_cxx():
    """A C++ compiler that can link OpenMP (finds ``libgomp.spec``):
    Inductor's configured one first (the ``CXX`` environment variable,
    else ``g++``), then ``g++`` / ``c++`` on PATH. AOTInductor links every
    package with ``-fopenmp``; the runner is built with the same compiler."""
    from torch._inductor import config
    cxx = config.cpp.cxx
    tried = [c for c in (cxx if isinstance(cxx, (list, tuple)) else [cxx])
             if c] + [shutil.which(c) for c in ("g++", "c++")]
    for c in tried:
        if not c:
            continue
        try:
            spec = subprocess.run([c, "-print-file-name=libgomp.spec"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        except OSError:
            continue
        if os.path.isabs(spec) and os.path.isfile(spec):
            return c
    raise RuntimeError(f"no C++ compiler of {tried} finds libgomp.spec, "
                       "which AOTInductor's link step (-fopenmp) needs")


def have_nvcc():
    """True where the CUDA kernels (and so the op library) can be built."""
    from ..ops.kernels import _build
    try:
        _build._nvcc()
    except RuntimeError:
        return False
    return True


def _torch_flags():
    """(compile flags, link flags) against the running torch's C++ API;
    the CUDA libraries linked --no-as-needed where torch has them, so that
    the runner finds the CUDA backend of a package."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    incs = [f"-I{p}" for p in cpp_extension.include_paths()]
    lib = cpp_extension.library_paths()[0]
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if os.path.exists(os.path.join(lib, "libtorch_cuda.so")):
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    return ([f"-D_GLIBCXX_USE_CXX11_ABI={abi}", *incs],
            [f"-L{lib}", "-Wl,--no-as-needed", *libs, "-Wl,--as-needed",
             f"-Wl,-rpath,{lib}"])


def _kernel_libs():
    from ..ops.kernels import _build
    return [_build._target(n)[1] for n in OPS_KERNELS]


def build_dir():
    """``build/native/<key>``: the key hashes what the outputs depend on."""
    import torch
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join([torch.__version__, *CXX_FLAGS,
                       *(p.name for p in _kernel_libs())]).encode())
    return BUILD_ROOT / h.hexdigest()[:12]


def paths():
    """{"dir", "lib", "run", "ops", "include"}: where ``build`` puts each
    piece, and the directory of the C header."""
    d = build_dir()
    return {"dir": d, "lib": d / LIB, "run": d / RUN, "ops": d / OPS,
            "include": CSRC}


class _Job:
    """The compiler processes of one build stage: each writes a temporary
    file that replaces its output once it succeeds."""

    def __init__(self, d):
        self.dir = d
        self.procs = []

    def start(self, name, cmd, out):
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(self.dir / f"{name}.log", "w")
        try:
            proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=log,
                                    stderr=subprocess.STDOUT)
        except OSError:
            log.close()
            raise
        self.procs.append((name, proc, log, tmp, out))

    def wait(self):
        failed = []
        for name, proc, log, tmp, out in self.procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                text = (self.dir / f"{name}.log").read_text()
                failed.append(f"{name} (rc {rc}):\n{text[-4000:]}")
        self.procs = []
        if failed:
            raise RuntimeError("native runtime build failed: " +
                               "\n".join(failed))

    def kill(self):
        for _, proc, log, tmp, _ in self.procs:
            proc.kill()
            proc.wait()
            log.close()
            tmp.unlink(missing_ok=True)
        self.procs = []


def start_build(ops=None):
    """Start the compiles of the runner library, ``ptt_run``'s object and
    (``ops``, default: where nvcc is) the op library's object, all at
    once. Returns the state that ``finish_build`` completes (the one of a
    build this process has started already, when it covers `ops`), or None
    when everything is built already."""
    ops = have_nvcc() if ops is None else ops
    p = paths()
    d = p["dir"]
    pending = _PENDING.get(d)
    if pending is not None:
        if pending["ops"] or not ops:
            return pending
        finish_build(pending)
    wanted = [p["lib"], p["run"]] + ([p["ops"]] if ops else [])
    if all(f.exists() for f in wanted):
        return None
    d.mkdir(parents=True, exist_ok=True)
    cflags, lflags = _torch_flags()
    cxx = openmp_cxx()
    job = _Job(d)
    state = {"t0": time.perf_counter(), "job": job, "ops": ops,
             "cxx": cxx, "lflags": lflags}
    try:
        if not p["lib"].exists():
            job.start("lib", [cxx, *CXX_FLAGS, "-shared", *cflags,
                              f"-I{CSRC}", str(CSRC / "runner.cpp"),
                              str(CSRC / "c_api.cpp"), *lflags, "-ldl"],
                      p["lib"])
        if not p["run"].exists():
            job.start("run_main", [cxx, *CXX_FLAGS, "-c", f"-I{CSRC}",
                                   str(CSRC / "run_main.cpp")],
                      d / "run_main.o")
        if ops and not p["ops"].exists():
            job.start("ops", [cxx, *CXX_FLAGS, "-c", *cflags,
                              str(CSRC / "ops.cpp")], d / "ops.o")
    except BaseException:
        job.kill()
        raise
    _PENDING[d] = state
    return state


def finish_build(state):
    """Wait for ``start_build``'s compiles, then link ``ptt_run`` against
    the runner and the op library against the kernel libraries (building
    those first if needed). Returns the build's seconds (0.0 when there
    was nothing to build); raises on any failure."""
    if state is None:
        return 0.0
    if "seconds" in state:
        return state["seconds"]
    job, p = state["job"], paths()
    d, cxx = p["dir"], state["cxx"]
    try:
        job.wait()
        if not p["run"].exists():
            job.start("ptt_run", [cxx, str(d / "run_main.o"), f"-L{d}",
                                  "-lptt_native", "-Wl,-rpath,$ORIGIN"],
                      p["run"])
        if state["ops"] and not p["ops"].exists():
            from ..ops.kernels import _build
            _build.build_all(OPS_KERNELS)
            kernels = _kernel_libs()
            job.start("ops_link", [cxx, "-shared", str(d / "ops.o"),
                                   f"-L{_build.BUILD_DIR}",
                                   *(f"-l:{k.name}" for k in kernels),
                                   "-Wl,-rpath,$ORIGIN/../../kernels",
                                   *state["lflags"]], p["ops"])
        job.wait()
    except BaseException:
        job.kill()
        raise
    finally:
        _PENDING.pop(d, None)
    state["seconds"] = time.perf_counter() - state["t0"]
    return state["seconds"]


def build(ops=None):
    """Build what is missing (``start_build`` + ``finish_build``) and
    return ``paths()``."""
    finish_build(start_build(ops))
    return paths()


def _declare(lib):
    c_char_p, c_int, c_int64, c_void_p = (ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int64, ctypes.c_void_p)
    ptr = ctypes.POINTER
    sigs = {
        "ptt_native_load": (c_void_p, [c_char_p, c_char_p, c_char_p, c_int]),
        "ptt_native_platform": (c_int, [c_void_p, c_char_p, c_int]),
        "ptt_native_num_outputs": (c_int64, [c_void_p]),
        "ptt_native_execute": (c_int, [
            c_void_p, c_int, ptr(c_void_p), ptr(c_int64), ptr(c_int),
            ptr(c_int), ptr(c_void_p), ptr(c_int64), c_int, c_char_p,
            c_int]),
        "ptt_native_free_host": (None, [c_void_p]),
        "ptt_native_destroy": (None, [c_void_p]),
        "ptt_native_launch_counts": (c_int, [c_char_p, c_int]),
        "ptt_native_reset_launch_counts": (None, []),
        "ptt_native_selftest": (c_int, [c_char_p, c_char_p, c_int]),
        "ptt_predictor_create": (c_void_p, [c_char_p, c_char_p, c_char_p,
                                            c_int]),
        "ptt_predictor_num_outputs": (c_int64, [c_void_p]),
        "ptt_predictor_platform": (c_int, [c_void_p, c_char_p, c_int]),
        "ptt_predictor_run": (c_int, [
            c_void_p, c_int, ptr(c_void_p), ptr(c_int64), ptr(c_int),
            ptr(c_int), ptr(c_void_p), ptr(c_int64), c_int, c_char_p,
            c_int]),
        "ptt_predictor_destroy": (None, [c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def get_native_lib():
    """The runner library (``libptt_native.so``) through ctypes, building
    the runner and ``ptt_run`` first when they are missing. Raises when the
    build fails: there is no other way to run a package."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = build(ops=False)["lib"]
            _LIB = _declare(ctypes.CDLL(str(lib)))
    return _LIB


# dtype codes of the C API: paddle_tpu/inference/native.py's _DTYPE_CODES
DTYPE_CODES = {
    "float32": 0, "float64": 1, "bfloat16": 2, "float16": 3,
    "int8": 4, "int16": 5, "int32": 6, "int64": 7,
    "uint8": 8, "uint32": 9, "uint64": 10, "bool": 11,
}

__all__ = ["BUILD_ROOT", "CSRC", "DTYPE_CODES", "OPS_KERNELS", "build",
           "build_dir", "finish_build", "get_native_lib", "have_nvcc",
           "openmp_cxx", "paths", "start_build"]
