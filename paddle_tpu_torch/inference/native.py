"""The native deploy predictor over a jit.save artifact: the counterpart
of ``paddle_tpu/inference/native.py``.

The JAX package compiles the closed StableHLO program through the PJRT C
API. The port's counterpart of that compiled program is an AOTInductor
package: ``torch._inductor.aoti_compile_and_package`` compiles the
``jit.load``'ed program (the ``.pdiparams`` weights in it) once into
``<path>.aoti.pt2``, for the device it runs on, and a later construction
over the same program, weights and device reuses that file (the key is
kept in ``<path>.aoti.json``). Inductor links the package with
``-fopenmp``, so the compile uses ``runtime.openmp_cxx()``.

The package then runs through the native runtime's C API
(``ptt_predictor_*`` of ``csrc/native/paddle_tpu_torch_c_api.h`` over
``ctypes``), as the JAX predictor runs through ``pjrt_runner.cc``: the
same library serves ``ptt_run`` and a plain C client with no Python in
the process. Here, in a Python process, the package reaches the kernels
as the ``ptt`` ops that ``ops.kernels`` registers (counted in
``<wrapper>.launches``); without Python, the C++ ops of ``ops.cpp``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..runtime import DTYPE_CODES


def _digest(paths, device):
    h = hashlib.sha256(f"{torch.__version__} {device}".encode())
    for p in paths:
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
    return h.hexdigest()


class NativePredictor:
    """Run a jit.save artifact with a static signature
    (``<path>.pt2`` / ``.pdiparams`` / ``.native.json``) as an
    AOTInductor package on `device` (the current device: the card unless
    the CPU was asked for). ``compile_s`` is the construction's compile
    time (0.0 when the package was reused)."""

    def __init__(self, path, device=None):
        from torch._inductor import aoti_compile_and_package

        from .. import runtime
        from ..device import resolve_device
        from ..jit import load as jit_load
        with open(path + ".native.json") as f:
            self.meta = json.load(f)
        if "error" in self.meta:
            raise RuntimeError(
                f"artifact has no native program: {self.meta['error']}")
        self._device = resolve_device(device)
        package = path + ".aoti.pt2"
        key = _digest([path + ".pt2", path + ".pdiparams"], self._device)
        try:
            with open(path + ".aoti.json") as f:
                fresh = json.load(f).get("key") == key and \
                    os.path.isfile(package)
        except FileNotFoundError:
            fresh = False
        self.compile_s = 0.0
        if not fresh:
            from torch._inductor import config
            t0 = time.perf_counter()
            program = jit_load(path, device=self._device).program()
            # one compile of one wrapper: precompiling the headers first
            # only adds their parse (15-20 s of a 20-67 s compile of the
            # tiny Llama on a CPU host); on the card the package's host code
            # is the wrapper alone, so Inductor's probe of the CPU's vector
            # ISAs (a test build per ISA, ~25 s on a CPU host) is skipped
            opts = {"cpp.cxx": (None, runtime.openmp_cxx()),
                    "aot_inductor.precompile_headers": False}
            if self._device.type == "cuda":
                opts["cpp.vec_isa_ok"] = False
            with config.patch(opts):
                aoti_compile_and_package(program, package_path=package)
            self.compile_s = time.perf_counter() - t0
            with open(path + ".aoti.json", "w") as f:
                json.dump({"key": key}, f)
        # the ptt ops the package calls, defined before it is loaded
        from ..ops import kernels  # noqa: F401
        self._lib = runtime.get_native_lib()
        err = ctypes.create_string_buffer(1024)
        self._pred = self._lib.ptt_predictor_create(
            path.encode(), str(self._device).encode(), err, 1024)
        if not self._pred:
            raise RuntimeError(f"native predictor: {err.value.decode()}")
        self.num_outputs = int(self._lib.ptt_predictor_num_outputs(
            self._pred))

    def platform(self):
        buf = ctypes.create_string_buffer(64)
        self._lib.ptt_predictor_platform(self._pred, buf, 64)
        return buf.value.decode()

    def run(self, *inputs):
        """inputs: numpy arrays (or tensors) matching the exported
        signature, converted to its types; a shape other than the
        exported one raises ValueError. Returns each output's bytes as a
        flat uint8 array, as the JAX package's runner does."""
        from ..framework.io import _from_numpy
        specs = self.meta["inputs"]
        if len(inputs) != len(specs):
            raise ValueError(f"expected {len(specs)} inputs, "
                             f"got {len(inputs)}")
        xs = []
        for a, spec in zip(inputs, specs):
            t = a if isinstance(a, torch.Tensor) else \
                _from_numpy(np.ascontiguousarray(a))
            if list(t.shape) != list(spec["shape"]):
                raise ValueError(
                    f"input shape {tuple(t.shape)} != exported "
                    f"{spec['shape']}")
            xs.append(t.detach().to("cpu", getattr(torch, spec["dtype"]))
                      .contiguous())
        n = len(xs)
        dims = [d for t in xs for d in t.shape]
        data = (ctypes.c_void_p * n)(*[t.data_ptr() for t in xs])
        dims_arr = (ctypes.c_int64 * max(len(dims), 1))(*dims)
        ranks = (ctypes.c_int * n)(*[t.dim() for t in xs])
        codes = (ctypes.c_int * n)(
            *[DTYPE_CODES[str(t.dtype).removeprefix("torch.")] for t in xs])
        max_out = max(self.num_outputs, 1)
        out_ptrs = (ctypes.c_void_p * max_out)()
        out_sizes = (ctypes.c_int64 * max_out)()
        err = ctypes.create_string_buffer(4096)
        n_out = self._lib.ptt_predictor_run(
            self._pred, n, data, dims_arr, ranks, codes, out_ptrs,
            out_sizes, max_out, err, 4096)
        if n_out < 0:
            raise RuntimeError(f"native predictor run: "
                               f"{err.value.decode()}")
        outs = []
        for i in range(n_out):       # one copy out of the library's buffer
            buf = (ctypes.c_uint8 * out_sizes[i]).from_address(out_ptrs[i])
            outs.append(np.frombuffer(buf, dtype=np.uint8).copy())
            self._lib.ptt_native_free_host(out_ptrs[i])
        return outs

    def close(self):
        if getattr(self, "_pred", None):
            self._lib.ptt_predictor_destroy(self._pred)
            self._pred = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
