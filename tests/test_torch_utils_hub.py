"""The port's ``utils`` (``cpp_extension``, ``unique_name``,
``require_version``, ``deprecated``, ``try_import``, ``run_check``,
``get_build_directory``, ``dlpack``), ``hub`` and ``regularizer`` against
the JAX package's, on the CPU.

- ``cpp_extension.load`` of an axpy op written against ``TORCH_LIBRARY``,
  called eagerly and inside ``jit.to_static`` (through the result spec's
  abstract evaluation), against the JAX test's XLA FFI axpy
  (``tests/test_native_runtime.py``) on the same inputs; ``setup``
  refuses ``CUDAExtension`` in both packages and hands a ``CppExtension``'s
  sources to ``load``;
- ``unique_name`` sequences, ``require_version``, ``deprecated``,
  ``try_import`` and ``get_build_directory`` equal to the JAX package's;
- a ``dlpack`` round trip (shared memory) and a JAX array read through the
  protocol;
- ``hub.list`` / ``help`` / ``load`` on one local ``hubconf.py`` directory
  giving the JAX package's names and outputs, ``load_state_dict_from_url``
  on ``file://`` URLs and the hub directory;
- ``regularizer`` equal to ``optimizer.regularizer``.
"""

import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.hub as jhub
import paddle_tpu.regularizer as jregularizer
import paddle_tpu.utils as jutils
import paddle_tpu.version as jversion

import paddle_tpu_torch as ptt
from paddle_tpu_torch import hub, jit, regularizer, utils
from paddle_tpu_torch.utils import cpp_extension, dlpack
from torch_parity import cpu_device  # noqa: F401

AXPY_CPP = r'''
#include <ATen/ATen.h>
#include <torch/library.h>

static at::Tensor axpy(const at::Tensor& x, const at::Tensor& y,
                       double alpha) {
  TORCH_CHECK(x.scalar_type() == at::kFloat && y.sizes() == x.sizes());
  at::Tensor xc = x.contiguous(), yc = y.contiguous();
  at::Tensor out = at::empty_like(xc);
  const float* px = xc.data_ptr<float>();
  const float* py = yc.data_ptr<float>();
  float* po = out.data_ptr<float>();
  for (int64_t i = 0; i < xc.numel(); i++)
    po[i] = static_cast<float>(alpha) * px[i] + py[i];
  return out;
}

TORCH_LIBRARY(ptt_axpy_ext, m) {
  m.def("axpy(Tensor x, Tensor y, float alpha) -> Tensor");
}
TORCH_LIBRARY_IMPL(ptt_axpy_ext, CPU, m) { m.impl("axpy", &axpy); }
'''

# the JAX test's handler (tests/test_native_runtime.py)
AXPY_FFI = r'''
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

static ffi::Error AxpyImpl(float alpha, ffi::Buffer<ffi::F32> x,
                           ffi::Buffer<ffi::F32> y,
                           ffi::ResultBuffer<ffi::F32> out) {
  size_t n = x.element_count();
  for (size_t i = 0; i < n; i++) {
    out->typed_data()[i] = alpha * x.typed_data()[i] + y.typed_data()[i];
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(Axpy, AxpyImpl,
                              ffi::Ffi::Bind()
                                  .Attr<float>("alpha")
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
'''

X = np.asarray([1.0, 2.0, 3.0], np.float32)
Y = np.asarray([10.0, 20.0, 30.0], np.float32)
SPEC = types.SimpleNamespace(shape=(3,), dtype=np.float32)


@pytest.fixture(scope="module")
def axpy(tmp_path_factory):
    d = tmp_path_factory.mktemp("axpy")
    src = d / "axpy.cpp"
    src.write_text(AXPY_CPP)
    return cpp_extension.load("axpy_ext", [str(src)],
                              functions=[("ptt_axpy_ext::axpy",
                                          "paddle_tpu_axpy")],
                              build_directory=str(d))


def _jax_axpy(tmp_path, alpha):
    from paddle_tpu.framework.jax_compat import jax_ffi
    if jax_ffi() is None:
        pytest.skip("the JAX side needs the XLA-FFI surface")
    import jax
    src = tmp_path / "axpy_ffi.cc"
    src.write_text(AXPY_FFI)
    # a target name of its own: JAX's FFI registry is process-wide, and
    # tests/test_native_runtime.py registers "paddle_tpu_axpy" from
    # another library when both files share a test process
    ext = jutils.cpp_extension.load("axpy_ffi_ext", [str(src)],
                                    functions=[("Axpy",
                                                "paddle_tpu_axpy_ref")],
                                    build_directory=str(tmp_path))
    call = ext.ffi_call("paddle_tpu_axpy_ref",
                        jax.ShapeDtypeStruct((3,), np.float32))
    return call(paddle.to_tensor(X), paddle.to_tensor(Y),
                alpha=np.float32(alpha)).numpy()


def test_cpp_extension_axpy_against_the_jax_ffi_axpy(axpy, tmp_path):
    assert axpy.targets == ("paddle_tpu_axpy",)
    assert os.path.isfile(axpy.lib_path)
    call = axpy.ffi_call("paddle_tpu_axpy", SPEC)
    out = call(torch.from_numpy(X), torch.from_numpy(Y),
               alpha=np.float32(2.0))
    np.testing.assert_array_equal(out.numpy(), [12.0, 24.0, 36.0])
    np.testing.assert_array_equal(out.numpy(), _jax_axpy(tmp_path, 2.0))


def test_cpp_extension_op_inside_to_static(axpy):
    call = axpy.ffi_call("paddle_tpu_axpy", SPEC)
    st = jit.to_static(lambda a, b: call(a, b, alpha=np.float32(0.5)))
    got = st(torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_array_equal(got.numpy(), [10.5, 21.0, 31.5])
    graphs = st.programs()
    assert graphs and any("ptt_axpy_ext.axpy" in str(g.graph)
                          for g in graphs)


def test_cpp_extension_result_spec_is_checked(axpy):
    bad = types.SimpleNamespace(shape=(4,), dtype=np.float32)
    call = axpy.ffi_call("paddle_tpu_axpy", bad)
    with pytest.raises(ValueError, match="differ from the spec"):
        call(torch.from_numpy(X), torch.from_numpy(Y), alpha=1.0)
    plain = axpy.ffi_call("paddle_tpu_axpy")
    np.testing.assert_array_equal(
        plain(torch.from_numpy(X), torch.from_numpy(Y), alpha=1.0).numpy(),
        X + Y)


def test_setup_refuses_cuda_extension_and_builds_cpp_extension(
        monkeypatch):
    for pkg in (jutils, utils):
        ext = pkg.cpp_extension.CUDAExtension(["k.cu"])
        assert isinstance(ext, pkg.cpp_extension.CppExtension)
        with pytest.raises(RuntimeError, match="CUDAExtension"):
            pkg.cpp_extension.setup(name="k", ext_modules=[ext])
    with pytest.raises(RuntimeError, match="paddle_tpu_torch/csrc") as e:
        utils.cpp_extension.setup(
            name="k", ext_modules=utils.CUDAExtension(["k.cu"]))
    assert "ops/kernels/_build.py" in str(e.value)
    seen = []
    monkeypatch.setattr(utils.cpp_extension, "load",
                        lambda name, sources: seen.append((name, sources))
                        or name)
    assert utils.cpp_extension.setup(
        name="e", ext_modules=[utils.CppExtension(["a.cpp", "b.cpp"])]) == \
        ["e"]
    assert seen == [("e", ["a.cpp", "b.cpp"])]
    inc = utils.cpp_extension.include_paths()
    assert any(os.path.isfile(os.path.join(p, "torch", "library.h"))
               for p in inc)


def _unique_name_trace(u):
    out = []
    with u.unique_name.guard():
        out += [u.unique_name("fc"), u.unique_name.generate("fc"),
                u.unique_name.generate("conv"), u.unique_name()]
        with u.unique_name.guard():
            out += [u.unique_name.generate("fc")]
        out += [u.unique_name.generate("fc"),
                u.unique_name_ns.generate("fc")]
        old = u.unique_name.switch()
        out += [sorted(old.items()), u.unique_name.generate("fc")]
        with u.unique_name_ns.guard("x"):
            out += [u.unique_name_ns.generate()]
    return out


def test_unique_name_sequences_equal_jax():
    assert _unique_name_trace(utils) == _unique_name_trace(jutils)


def test_require_version_deprecated_try_import_equal_jax(monkeypatch,
                                                         tmp_path):
    # the JAX function reads paddle_tpu.version.__version__, which that
    # module does not define: give it the same full_version for the test
    monkeypatch.setattr(jversion, "__version__", jversion.full_version,
                        raising=False)
    assert ptt.version.full_version == jversion.full_version
    for lo, hi in (("0.0.1", None), ("0.1.0", None), ("0.1", "0.1.0"),
                   ("0.2.0", None), ("1.0", None), ("0.0.9", "0.0.10"),
                   ("0.1.0", "0.1.1")):
        results = []
        for pkg in (jutils, utils):
            try:
                results.append(pkg.require_version(lo, hi))
            except RuntimeError as e:
                results.append(str(e))
        assert results[0] == results[1], (lo, hi, results)

    def f(a):
        return a + 1
    for pkg in (jutils, utils):
        assert pkg.deprecated(update_to="g", since="2.0", reason="r")(f) is f
        assert pkg.try_import("json").__name__ == "json"
        with pytest.raises(ImportError, match="no_such_module_xyz is "
                                              "required"):
            pkg.try_import("no_such_module_xyz")
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path / "ext"))
    assert utils.get_build_directory() == jutils.get_build_directory() == \
        str(tmp_path / "ext")
    assert utils.cpp_extension.get_build_directory() == str(tmp_path / "ext")


def test_run_check_on_the_cpu(capsys):
    utils.run_check(device="cpu")
    assert "paddle_tpu_torch works on cpu" in capsys.readouterr().out


def test_dlpack_round_trip_and_jax_arrays():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert torch.equal(back, t) and back.data_ptr() == t.data_ptr()
    back[0, 0] = 7.0                  # the memory is shared
    assert t[0, 0] == 7.0
    j = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    got = dlpack.from_dlpack(jutils.dlpack.to_dlpack(j))
    np.testing.assert_array_equal(got.numpy(), j.numpy())
    assert utils.dlpack is dlpack


HUBCONF = '''
def double(x=2):
    """Twice x."""
    return 2 * x


def pair(a, b=3):
    """(a, b) as a list."""
    return [a, b]


def _private():
    return None


NOT_CALLABLE = 5
'''


def test_hub_on_a_local_repo_equals_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert hub.list(repo) == jhub.list(repo) == ["double", "pair"]
    assert hub.help(repo, "pair") == jhub.help(repo, "pair") == \
        "(a, b) as a list."
    assert hub.load(repo, "double", 21) == jhub.load(repo, "double", 21)
    assert hub.load(repo, "pair", 1, b=5) == jhub.load(repo, "pair", 1, b=5)
    for pkg in (hub, jhub):
        with pytest.raises(RuntimeError, match="no network egress"):
            pkg.list(repo, source="github")
        with pytest.raises(FileNotFoundError, match="no hubconf.py"):
            pkg.list(str(tmp_path / "none"))


def test_hub_dir_and_load_state_dict_from_url(tmp_path):
    old = hub.get_dir()
    try:
        hub.set_dir(str(tmp_path))
        assert hub.get_dir() == str(tmp_path)
        w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        path = tmp_path / "w.pdparams"
        ptt.save({"w": w}, str(path))
        for url in (f"file://{path}", str(path), "https://example.invalid/"
                    "w.pdparams"):
            got = hub.load_state_dict_from_url(url)
            assert torch.equal(got["w"], w)
        jgot = jhub.load_state_dict_from_url(f"file://{path}")
        np.testing.assert_array_equal(np.asarray(jgot["w"].numpy()),
                                      w.numpy())
        with pytest.raises(RuntimeError, match="no network egress"):
            hub.load_state_dict_from_url("https://example.invalid/x.pd")
    finally:
        hub.set_dir(old)


def test_regularizer_is_optimizer_regularizer():
    from paddle_tpu_torch.optimizer import regularizer as oreg
    assert regularizer.L1Decay is oreg.L1Decay
    assert regularizer.L2Decay is oreg.L2Decay
    names = {n for n in dir(jregularizer) if not n.startswith("_")}
    assert {n for n in dir(regularizer) if not n.startswith("_")} == names
    assert str(regularizer.L2Decay(0.5)) == str(jregularizer.L2Decay(0.5))
