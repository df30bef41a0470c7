"""The port's Python-free native runtime (``paddle_tpu_torch/runtime``,
``csrc/native``) against the JAX package's (``paddle_tpu/runtime``), on
the CPU.

- the seven ``TORCH_LIBRARY`` schemas of ``csrc/native/ops.cpp`` (parsed)
  equal to the schemas ``torch.library.custom_op`` infers for the Python
  ops, string for string; and the op library itself (linked here against
  stand-ins for the CUDA kernel libraries, which need nvcc), loaded into a
  process that defined no Python op, gives the same schemas through the
  dispatcher and refuses a CPU tensor with the op's name;
- ``ptt_run``'s argument format and dtype codes equal to ``pjrt_run``'s
  (``pjrt_run_main.cc``) and to ``paddle_tpu/inference/native.py``'s;
  the C header's ``ptt_predictor_*`` (and ``ptt_native_execute``) equal to
  ``paddle_tpu_c_api.h``'s ``ptq_predictor_*`` (``ptq_pjrt_execute``),
  the plugin path replaced by the device;
- the whole slice: the JAX test's MLP (``test_native_runtime.py``'s
  ``pjrt_run`` net, its weights carried over) saved by both packages; the
  port's AOTInductor package run by ``ptt_run`` (no Python variables in
  its environment), by the C client ``examples/ptt_c_client.c`` and by
  ``NativePredictor`` through the C API, each held against the JAX
  ``pjrt_run`` on its CPU stub plugin and against eager (rtol 1e-5, atol
  1e-6);
- the error paths: a missing package, a wrong input count, bad specs
  (through ``ptt_run`` and through the C API);
- the runtime modules import neither JAX nor ``paddle_tpu``.

The runner, the C API and ``ptt_run`` are built with g++ for the CPU (the
build runs while the module's fixture compiles the package).
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.inference import native as jnative

from paddle_tpu_torch import jit, nn, runtime, weights
from paddle_tpu_torch.inference.native import NativePredictor
from paddle_tpu_torch.ops.kernels import _ops  # noqa: F401  (the ptt ops)
from torch_parity import cpu_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CSRC = os.path.join(REPO, "paddle_tpu", "runtime", "csrc")
CSRC = str(runtime.CSRC)
RTOL, ATOL = 1e-5, 1e-6
# the forward ops an exported inference program can hold
FORWARD_OPS = ("rms_norm", "swiglu", "fused_rope", "fused_rope_qk",
               "flash_attention_fwd", "flashmask_attention_fwd",
               "bias_dropout_residual_ln")
X = (np.arange(8, dtype=np.float32) * 0.1).reshape(2, 4)


def _read(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


def _python_schema(op):
    return str(getattr(torch.ops.ptt, op).default._schema)


def _cpp_schemas():
    """{op: schema} of ops.cpp's m.def strings (adjacent literals joined)."""
    src = _read(CSRC, "ops.cpp")
    out = {}
    for body in re.findall(r'm\.def\(((?:\s*"[^"]*")+)\)', src):
        schema = "".join(re.findall(r'"([^"]*)"', body))
        out[schema.split("(")[0]] = "ptt::" + schema
    return out


def _scrubbed_env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith("PYTHON")}


def test_cpp_schemas_equal_python_ops_schemas():
    cpp = _cpp_schemas()
    assert sorted(cpp) == sorted(FORWARD_OPS)
    for op in FORWARD_OPS:
        assert cpp[op] == _python_schema(op), op


_KERNEL_STAND_INS = "\n".join(
    f'extern "C" int {sym}() {{ return 999; }}' for sym in (
        "ptt_rms_norm", "ptt_swiglu", "ptt_rope",
        "ptt_flash_attention_fwd_sm90", "ptt_flashmask_attention_fwd_sm90",
        "ptt_flash_attention_fwd", "ptt_flashmask_attention_fwd",
        "ptt_bias_dropout_residual_ln"))


def test_op_library_defines_the_python_schemas_and_refuses_cpu(tmp_path):
    stand_ins = tmp_path / "kernels.cpp"
    stand_ins.write_text(_KERNEL_STAND_INS + "\n")
    lib = tmp_path / "libptt_ops.so"
    cflags, lflags = runtime._torch_flags()
    r = subprocess.run([runtime.openmp_cxx(), *runtime.CXX_FLAGS, "-shared",
                        *cflags, os.path.join(CSRC, "ops.cpp"),
                        str(stand_ins), "-o", str(lib), *lflags],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    code = (
        "import json, sys, torch\n"
        f"torch.ops.load_library({str(lib)!r})\n"
        f"out = {{op: str(getattr(torch.ops.ptt, op).default._schema) "
        f"for op in {FORWARD_OPS!r}}}\n"
        "try:\n"
        "    torch.ops.ptt.rms_norm(torch.ones(2, 4), torch.ones(4), 1e-6)\n"
        "except RuntimeError as e:\n"
        "    out['error'] = str(e).splitlines()[0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'paddle_tpu', 'paddle_tpu_torch')]\n"
        "out['modules'] = bad\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out.pop("modules") == []
    error = out.pop("error")
    assert error.startswith("ptt::rms_norm: tensors on cpu"), error
    assert out == {op: _python_schema(op) for op in FORWARD_OPS}


def _codes(text):
    """{code: name} of a '0=f32 1=f64 ...' list (JAX's pred is bool)."""
    pairs = re.findall(r"(\d+)=(\w+)", text)
    return {int(c): {"pred": "bool"}.get(n, n) for c, n in pairs}


def test_ptt_run_format_and_dtype_codes_match_pjrt_run():
    jax_head = "\n".join(_read(JAX_CSRC, "pjrt_run_main.cc").splitlines()[:9])
    ours = _read(CSRC, "run_main.cpp")
    fmt = "[dtype:rank:d0,d1,...:input.bin ...]"
    assert fmt in jax_head and fmt in ours
    assert "out_<i>.bin" in ours and "out_<i>.bin" in jax_head
    want = _codes(jax_head[jax_head.index("dtype codes"):])
    assert len(want) == 12
    assert _codes(ours[ours.index("dtype codes"):]) == want
    header = _read(CSRC, "paddle_tpu_torch_c_api.h")
    assert _codes(header[header.index("dtype codes"):]) == want
    assert runtime.DTYPE_CODES == jnative._DTYPE_CODES
    names = {"f32": "float32", "f64": "float64", "bf16": "bfloat16",
             "f16": "float16", "s8": "int8", "s16": "int16", "s32": "int32",
             "s64": "int64", "u8": "uint8", "u32": "uint32",
             "u64": "uint64", "bool": "bool"}
    assert {c: names[n] for c, n in want.items()} == \
        {c: n for n, c in runtime.DTYPE_CODES.items()}


def _declarations(path, prefix):
    """{function name: (return type, [parameters])} of a C header."""
    text = re.sub(r"/\*.*?\*/", "", _read(path), flags=re.S)
    out = {}
    for ret, name, params in re.findall(
            rf"([\w\*][\w\s\*]*?)\s*\b({prefix}\w+)\s*\(([^)]*)\)\s*;", text):
        plist = [" ".join(p.split()) for p in params.split(",")]
        out[name] = (" ".join(ret.split()), plist)
    return out


def test_c_header_matches_the_jax_c_api_less_the_plugin():
    jax = _declarations(os.path.join(JAX_CSRC, "paddle_tpu_c_api.h"),
                        "ptq_")
    ours = _declarations(os.path.join(CSRC, "paddle_tpu_torch_c_api.h"),
                         "ptt_")
    jpred = {k.removeprefix("ptq_predictor_"): v for k, v in jax.items()
             if k.startswith("ptq_predictor_")}
    tpred = {k.removeprefix("ptt_predictor_"): v for k, v in ours.items()
             if k.startswith("ptt_predictor_")}
    assert sorted(tpred) == sorted(jpred) == \
        ["create", "destroy", "num_outputs", "platform", "run"]
    for name, (ret, params) in jpred.items():
        want = [p.replace("plugin_path", "device") for p in params]
        assert tpred[name] == (ret, want), name
    jexec, texec = jax["ptq_pjrt_execute"], ours["ptt_native_execute"]
    assert texec[0] == jexec[0]
    assert texec[1][1:] == jexec[1][1:]
    assert ours["ptt_native_free_host"] == \
        (jax["ptq_pjrt_free_host"][0], jax["ptq_pjrt_free_host"][1])


def test_runtime_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys; import paddle_tpu_torch.runtime, "
            "paddle_tpu_torch.inference.native, paddle_tpu_torch.utils, "
            "paddle_tpu_torch.utils.dlpack, paddle_tpu_torch.hub, "
            "paddle_tpu_torch.regularizer; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for root, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch",
                                               "runtime")):
        for f in files:
            if f.endswith(".py"):
                assert not re.search(r"^\s*(import|from)\s+(paddle_tpu|jax)"
                                     r"(\.|\s|$)", _read(root, f), re.M)


# -- the whole slice: the JAX pjrt_run test's MLP -----------------------------

def _stub_plugin_or_skip():
    from paddle_tpu.runtime import get_cpu_stub_plugin, get_pjrt_lib
    plugin = get_cpu_stub_plugin()
    if plugin is None:
        pytest.skip("stub plugin build unavailable")
    if get_pjrt_lib() is None:
        pytest.skip("native pjrt runtime unavailable")
    import importlib.util
    if not any(importlib.util.find_spec(m) for m in
               ("jaxlib._jax", "jaxlib.xla_extension")):
        pytest.skip("the stub's compile sidecar needs jaxlib's PJRT "
                    "bindings")
    os.environ.setdefault("PADDLE_TPU_STUB_PYTHON", sys.executable)
    return plugin


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The JAX test's MLP (seed 1: Linear(4, 8), Tanh, Linear(8, 2)) saved
    by the JAX package and, with its weights, by the port; the port's
    AOTInductor package compiled for the CPU by NativePredictor while g++
    builds the runner, the C API and ptt_run."""
    job = runtime.start_build(ops=False)
    try:
        d = tmp_path_factory.mktemp("native_mlp")
        paddle.seed(1)
        jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2))
        jpath = str(d / "jax_model")
        jjit.save(jm, jpath, input_spec=[paddle.to_tensor(X)])
        ref = jm(paddle.to_tensor(X)).numpy()
        tm = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.Tanh(),
                           nn.Linear(8, 2, device="cpu"))
        weights.from_paddle_tpu_state(
            {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()},
            tm)
        tm.eval()
        eager = tm(torch.from_numpy(X)).detach().numpy()
        tpath = str(d / "model")
        jit.save(tm, tpath, input_spec=[jit.InputSpec([2, 4], "float32")])
        pred = NativePredictor(tpath, device="cpu")
    finally:
        runtime.finish_build(job)
    (d / "x.bin").write_bytes(X.tobytes())
    return {"dir": d, "jpath": jpath, "tpath": tpath, "ref": ref,
            "eager": eager, "pred": pred, "paths": runtime.paths()}


def _out(path, shape=(2, 2)):
    return np.frombuffer(open(path, "rb").read(), np.float32).reshape(shape)


def _ptt_run(mlp, *args, cwd=None):
    return subprocess.run([str(mlp["paths"]["run"]), *args],
                          cwd=cwd or mlp["dir"], env=_scrubbed_env(),
                          capture_output=True, text=True, timeout=240)


def test_mlp_through_ptt_run_against_pjrt_run_and_eager(mlp, tmp_path):
    ldd = subprocess.run(["ldd", str(mlp["paths"]["run"])],
                         capture_output=True, text=True).stdout
    assert "libtorch" in ldd and "libpython" not in ldd
    r = _ptt_run(mlp, "--runs", "2", mlp["tpath"] + ".aoti.pt2",
                 f"0:2:2,4:{mlp['dir'] / 'x.bin'}", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "platform: cpu" in r.stderr
    assert len(re.findall(r"^run_s: ", r.stderr, re.M)) == 2
    assert "launches: none" in r.stderr       # no C++ op library on a CPU
    assert "out_0.bin 16 bytes" in r.stdout
    got = _out(tmp_path / "out_0.bin")
    np.testing.assert_allclose(got, mlp["eager"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, mlp["ref"], rtol=RTOL, atol=ATOL)

    plugin = _stub_plugin_or_skip()
    from paddle_tpu.runtime import _PJRT_BIN_PATH
    jdir = tmp_path / "pjrt"
    jdir.mkdir()
    j = subprocess.run([_PJRT_BIN_PATH, plugin, mlp["jpath"] + ".mlir",
                        mlp["jpath"] + ".copts",
                        f"0:2:2,4:{mlp['dir'] / 'x.bin'}"], cwd=jdir,
                       capture_output=True, text=True, timeout=240)
    assert j.returncode == 0, j.stderr
    np.testing.assert_allclose(got, _out(jdir / "out_0.bin"), rtol=RTOL,
                               atol=ATOL)


def test_mlp_through_the_c_client_equals_ptt_run(mlp, tmp_path):
    exe = tmp_path / "client"
    cc = subprocess.run(
        ["gcc", "-x", "c", os.path.join(REPO, "examples", "ptt_c_client.c"),
         "-x", "none", "-I", str(mlp["paths"]["include"]),
         str(mlp["paths"]["lib"]), f"-Wl,-rpath,{mlp['paths']['dir']}",
         "-o", str(exe)], capture_output=True, text=True)
    assert cc.returncode == 0, cc.stderr
    c = subprocess.run([str(exe), mlp["tpath"], "cpu", "0",
                        str(mlp["dir"] / "x.bin"), "2", "4"], cwd=tmp_path,
                       env=_scrubbed_env(), capture_output=True, text=True,
                       timeout=240)
    assert c.returncode == 0, c.stderr
    assert "platform=cpu outputs=1" in c.stdout
    got = _out(tmp_path / "c_out_0.bin")
    np.testing.assert_allclose(got, mlp["ref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, mlp["eager"], rtol=RTOL, atol=ATOL)
    r = _ptt_run(mlp, mlp["tpath"] + ".aoti.pt2",
                 f"0:2:2,4:{mlp['dir'] / 'x.bin'}", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "c_out_0.bin").read_bytes() == \
        (tmp_path / "out_0.bin").read_bytes()


def test_native_predictor_runs_through_the_c_api(mlp):
    pred = mlp["pred"]
    assert pred.platform() == "cpu" and pred.num_outputs == 1
    assert pred.compile_s > 0.0
    for _ in range(2):              # a second run reuses the loaded package
        out = pred.run(X)
        got = np.frombuffer(out[0].tobytes(), np.float32).reshape(2, 2)
        np.testing.assert_allclose(got, mlp["ref"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, mlp["eager"], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="expected 1 inputs"):
        pred.run(X, X)
    with pytest.raises(ValueError, match="input shape"):
        pred.run(X[:1])
    again = NativePredictor(mlp["tpath"], device="cpu")
    assert again.compile_s == 0.0
    assert again.run(X)[0].tobytes() == out[0].tobytes()


@pytest.mark.parametrize("case", [
    ("missing", 1, "load: cannot read package"),
    ("count", 1, "the package takes 1 inputs, got 2"),
    ("none", 1, "the package takes 1 inputs, got 0"),
    ("spec", 2, "bad input spec '0:2:2:"),
    ("rank", 2, "(rank 3 with 2 dims)"),
    ("dtype", 2, "(unknown dtype code 12)"),
    ("bytes", 2, "holds 32 bytes, the spec 40"),
    ("usage", 2, "usage: "),
], ids=lambda c: c[0])
def test_ptt_run_error_paths(mlp, tmp_path, case):
    name, rc, message = case
    pkg, x = mlp["tpath"] + ".aoti.pt2", mlp["dir"] / "x.bin"
    args = {"missing": [str(tmp_path / "none.pt2"), f"0:2:2,4:{x}"],
            "count": [pkg, f"0:2:2,4:{x}", f"0:2:2,4:{x}"],
            "none": [pkg],
            "spec": [pkg, f"0:2:2:{x}"],
            "rank": [pkg, f"0:3:2,4:{x}"],
            "dtype": [pkg, f"12:2:2,4:{x}"],
            "bytes": [pkg, f"0:2:2,5:{x}"],
            "usage": []}[name]
    r = _ptt_run(mlp, *args, cwd=tmp_path)
    assert r.returncode == rc, r.stderr
    assert message in r.stderr, r.stderr
    assert not (tmp_path / "out_0.bin").exists()


def test_c_api_error_paths(mlp, tmp_path):
    lib = runtime.get_native_lib()
    err = ctypes.create_string_buffer(1024)
    assert not lib.ptt_predictor_create(str(tmp_path / "none").encode(),
                                        b"cpu", err, 1024)
    assert "cannot read package" in err.value.decode()
    assert not lib.ptt_predictor_create(mlp["tpath"].encode(), b"cuda", err,
                                        1024)
    assert err.value.decode()       # no op library / no card: refused
    pred = lib.ptt_predictor_create(mlp["tpath"].encode(), b"cpu", err, 1024)
    assert pred, err.value.decode()
    try:
        x = np.ascontiguousarray(X)
        data = (ctypes.c_void_p * 1)(x.ctypes.data)
        dims = (ctypes.c_int64 * 2)(2, 4)
        outs = (ctypes.c_void_p * 1)()
        sizes = (ctypes.c_int64 * 1)()
        for ranks, codes, want in (((2,), (12,), "unknown dtype code 12"),
                                   ((-1,), (0,), "negative rank -1")):
            n = lib.ptt_predictor_run(
                pred, 1, data, dims, (ctypes.c_int * 1)(*ranks),
                (ctypes.c_int * 1)(*codes), outs, sizes, 1, err, 1024)
            assert n == -1 and want in err.value.decode(), err.value
        n = lib.ptt_predictor_run(
            pred, 1, data, dims, (ctypes.c_int * 1)(2),
            (ctypes.c_int * 1)(0), outs, sizes, 0, err, 1024)
        assert n == -1 and "room for 0" in err.value.decode()
        assert lib.ptt_native_launch_counts(err, 1024) == -1
    finally:
        lib.ptt_predictor_destroy(pred)
