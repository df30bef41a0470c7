"""paddle.utils: the counterpart of ``paddle_tpu/utils/__init__.py``:
``dlpack``, ``unique_name``, ``deprecated``, ``try_import``,
``run_check``, ``require_version``, ``get_build_directory`` and
``cpp_extension`` (custom C++ ops).

``cpp_extension``: the JAX package compiles a user's XLA FFI handler and
registers it as an FFI target. The port compiles C++ that registers ops
with the dispatcher through ``TORCH_LIBRARY`` (as
``csrc/native/ops.cpp`` registers the kernels), loads it with
``torch.ops.load_library`` and hands each op back as a callable on
tensors. ``CUDAExtension`` keeps the JAX contract: it is declared, and
``setup`` refuses it (the port's device kernels live in
``paddle_tpu_torch/csrc``, built by ``ops/kernels/_build.py``).
"""

import os

from . import dlpack  # noqa: F401

_counters = {}


class _UniqueName:
    """paddle.utils.unique_name namespace (generate/guard/switch), also
    callable for the short form."""

    def __call__(self, prefix="tmp"):
        return self.generate(prefix)

    @staticmethod
    def generate(key="tmp"):
        n = _counters.get(key, 0)
        _counters[key] = n + 1
        return f"{key}_{n}"

    @staticmethod
    def switch(new_generator=None):
        old = dict(_counters)
        _counters.clear()
        return old

    @staticmethod
    def guard(new_generator=None):
        import contextlib

        @contextlib.contextmanager
        def _g():
            saved = dict(_counters)
            _counters.clear()
            try:
                yield
            finally:
                _counters.clear()
                _counters.update(saved)
        return _g()


unique_name = _UniqueName()


class _UniqueNameNS:
    @staticmethod
    def generate(prefix="tmp"):
        return unique_name(prefix)

    class guard:
        def __init__(self, prefix=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False


unique_name_ns = _UniqueNameNS


def deprecated(update_to="", since="", reason="", level=0):
    def deco(fn):
        return fn
    return deco


def try_import(name):
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"{name} is required: {e}") from e


def run_check(device=None):
    """A 4 x 4 product on `device` (the card unless the CPU is asked
    for), and a line saying where the port runs."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    x = torch.randn(4, 4, device=dev)
    y = x @ x
    assert tuple(y.shape) == (4, 4)
    print(f"paddle_tpu_torch works on {dev} "
          f"({torch.cuda.device_count()} CUDA device(s)).")


def require_version(min_version, max_version=None):
    """ref: paddle.utils.require_version: raise unless the port's version
    lies in [min_version, max_version] (the first three numeric fields)."""
    from ..version import full_version as v

    def key(s):
        return [int(x) for x in str(s).split(".")[:3] if x.isdigit()]
    if key(v) < key(min_version):
        raise RuntimeError(f"requires >= {min_version}, have {v}")
    if max_version is not None and key(v) > key(max_version):
        raise RuntimeError(f"requires <= {max_version}, have {v}")
    return True


def get_build_directory():
    d = os.environ.get("PADDLE_EXTENSION_DIR",
                       os.path.expanduser(
                           "~/.cache/paddle_tpu_torch/extensions"))
    os.makedirs(d, exist_ok=True)
    return d


def _plain(v):
    """A numpy scalar as the Python number a schema's float/int takes."""
    import numpy as np
    return v.item() if isinstance(v, np.generic) else v


class cpp_extension:
    """Custom C++ ops (ref: paddle/utils/cpp_extension + PD_BUILD_OP,
    paddle/phi/api/ext/op_meta_info.h:1145).

    The op is C++ that defines and implements ops with ``TORCH_LIBRARY``
    / ``TORCH_LIBRARY_IMPL``, compiled against torch's headers, loaded
    with ``torch.ops.load_library`` and called through the dispatcher:
    eagerly, and inside ``jit.to_static`` when a result spec gives it an
    abstract evaluation (the JAX ``ffi_call``'s result_shape_dtypes).
    Device kernels are not built here (``CUDAExtension``)."""

    @staticmethod
    def include_paths():
        """torch's C++ include paths."""
        from torch.utils import cpp_extension as tce
        return list(tce.include_paths())

    @staticmethod
    def load(name, sources, functions=None, extra_cflags=(),
             build_directory=None, verbose=False, **kw):
        """Compile `sources` (C++ registering ops with TORCH_LIBRARY) into
        ``lib<name>.so`` under `build_directory` (a new temporary directory
        by default), load it, and name its ops: `functions` lists
        (qualified op name, target name) pairs or plain qualified names
        ("ns::op"); None takes every op the library defined. Returns a
        namespace with ``lib_path``, ``targets`` and ``ffi_call(target,
        result_shape_dtypes=None)``."""
        import subprocess
        import tempfile

        import torch

        from ..runtime import CXX_FLAGS, _torch_flags
        build_dir = build_directory or tempfile.mkdtemp(
            prefix=f"paddle_tpu_torch_ext_{name}_")
        so_path = os.path.join(build_dir, f"lib{name}.so")
        cflags, lflags = _torch_flags()
        cmd = ["g++", *CXX_FLAGS, "-shared", *cflags, *extra_cflags,
               "-o", so_path, *sources, *lflags]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"cpp_extension build failed:\n{r.stderr}")
        if verbose:
            print(f"[cpp_extension] built {so_path}")
        before = set(torch._C._dispatch_get_all_op_names())
        torch.ops.load_library(so_path)
        defined = sorted(set(torch._C._dispatch_get_all_op_names()) - before)
        if functions is None:
            functions = defined
        ops = {}
        for fn in functions:
            qualname, target = (fn if isinstance(fn, (tuple, list))
                                else (fn, fn))
            ns, op = qualname.split("::")
            ops[target] = (qualname, getattr(getattr(torch.ops, ns), op))

        class _Ext:
            lib_path = so_path
            targets = tuple(ops)

            @staticmethod
            def ffi_call(target, result_shape_dtypes=None, **ffi_kw):
                qualname, op = ops[target]
                spec = result_shape_dtypes
                if spec is not None:
                    _abstract_eval(qualname, spec)

                def run(*args, **callkw):
                    out = op(*[_plain(a) for a in args],
                             **{k: _plain(v) for k, v in callkw.items()})
                    if spec is not None:
                        _check_result(target, out, spec)
                    return out
                return run
        _Ext.__name__ = name
        return _Ext


def _torch_dtype(dtype):
    import numpy as np
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _specs(spec):
    return list(spec) if isinstance(spec, (list, tuple)) else [spec]


def _abstract_eval(qualname, spec):
    """Give the op a fake implementation from its result spec (shape and
    dtype), unless its library registered a Meta kernel: a capture runs on
    fake tensors."""
    import torch
    if torch._C._dispatch_has_kernel_for_dispatch_key(qualname, "Meta") or \
            qualname in _ABSTRACT:
        return
    specs = _specs(spec)

    def fake(*args, **kwargs):
        ref = next(a for a in args if isinstance(a, torch.Tensor))
        outs = [ref.new_empty(tuple(s.shape), dtype=_torch_dtype(s.dtype))
                for s in specs]
        return outs[0] if not isinstance(spec, (list, tuple)) else \
            tuple(outs)
    torch.library.register_fake(qualname, fake)
    _ABSTRACT.add(qualname)


_ABSTRACT = set()


def _check_result(target, out, spec):
    outs = out if isinstance(out, (list, tuple)) else [out]
    specs = _specs(spec)
    got = [(tuple(o.shape), o.dtype) for o in outs]
    want = [(tuple(s.shape), _torch_dtype(s.dtype)) for s in specs]
    if got != want:
        raise ValueError(f"{target}: results {got} differ from the spec "
                         f"{want}")


class CppExtension:
    """ref cpp_extension.CppExtension: setup()'s source spec."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


class CUDAExtension(CppExtension):
    """CUDA extension spec: declared for API parity, as in the JAX
    package; building one raises. The port's device kernels are CUDA C++
    under paddle_tpu_torch/csrc, built by ops/kernels/_build.py."""


def _ext_setup(name=None, ext_modules=None, **kwargs):
    """ref cpp_extension.setup: builds CppExtension sources into a
    loadable library, as cpp_extension.load does."""
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) \
        else [ext_modules]
    outs = []
    for ext in exts:
        if ext is None:
            continue
        if isinstance(ext, CUDAExtension):
            raise RuntimeError(
                "CUDAExtension is not built by setup: the port's device "
                "kernels are CUDA C++ under paddle_tpu_torch/csrc, built by "
                "paddle_tpu_torch/ops/kernels/_build.py; host ops go "
                "through cpp_extension.load")
        outs.append(cpp_extension.load(name=name or "ext",
                                       sources=ext.sources))
    return outs


cpp_extension.CppExtension = CppExtension
cpp_extension.CUDAExtension = CUDAExtension
cpp_extension.get_build_directory = staticmethod(get_build_directory)
cpp_extension.setup = staticmethod(_ext_setup)
