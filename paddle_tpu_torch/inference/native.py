"""The native deploy predictor over a jit.save artifact: the counterpart
of ``paddle_tpu/inference/native.py``.

The JAX package compiles the closed StableHLO program through the PJRT C
API. The port's counterpart of that compiled program is an AOTInductor
package: ``torch._inductor.aoti_compile_and_package`` compiles the
``jit.load``'ed program (the ``.pdiparams`` weights in it) once into
``<path>.aoti.pt2``, for the device it runs on, and a later construction
over the same program, weights and device reuses that file (the key is
kept in ``<path>.aoti.json``); ``aoti_load_package`` runs it.

Inductor links the package with ``-fopenmp``, so the C++ compiler must
find OpenMP's ``libgomp.spec``: the one Inductor is configured with (the
``CXX`` environment variable, else ``g++``) when it does, else the first
``g++`` / ``c++`` on ``PATH`` that does (``_openmp_cxx``).

The kernels are ``ptt`` custom ops registered from Python, so the
compiled package calls them back through the dispatcher: unlike the JAX
package's runner, this one is not free of Python. A Python-free runner
needs the kernels registered as C++ ops.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch


def _openmp_cxx():
    """A C++ compiler that can link OpenMP (finds ``libgomp.spec``):
    Inductor's configured one first, then ``g++`` / ``c++`` on PATH."""
    import shutil
    import subprocess

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
        from torch._inductor import aoti_compile_and_package, \
            aoti_load_package

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
            opts = {"cpp.cxx": (None, _openmp_cxx()),
                    "aot_inductor.precompile_headers": False}
            if self._device.type == "cuda":
                opts["cpp.vec_isa_ok"] = False
            with config.patch(opts):
                aoti_compile_and_package(program, package_path=package)
            self.compile_s = time.perf_counter() - t0
            with open(path + ".aoti.json", "w") as f:
                json.dump({"key": key}, f)
        self._runner = aoti_load_package(package)
        self.num_outputs = None

    def platform(self):
        return "cuda" if self._device.type == "cuda" else "cpu"

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
            xs.append(t.to(self._device, getattr(torch, spec["dtype"])))
        with torch.no_grad():
            outs = self._runner(*xs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        self.num_outputs = len(outs)
        return [_bytes(o) for o in outs]


def _bytes(t):
    """A tensor's bytes as a flat uint8 numpy array."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().copy()
