"""The port's deploy path against the JAX package's, on the CPU.

- ``jit.save`` / ``jit.load`` of a small MLP (the JAX inference test's
  net, the same weights) and of ``LlamaConfig.tiny()``: the loaded
  programs' outputs against the JAX package's loaded programs (float32,
  atol 1e-4, as ``test_torch_llama.py``: the same products summed in
  other orders), and the port's loaded program bit-equal to its eager
  forward;
- the ``.pdiparams`` file crosses both ways: the JAX package's file loads
  into the port's artifact (a Llama exported with other weights) and
  gives the JAX program's outputs, the port's file unpickles into the
  JAX ``TranslatedLayer``'s inputs and gives the port's outputs; the
  parameter and buffer names and order are the JAX model's;
- the dynamic-batch ``Predictor`` (batch 1 through the handles),
  ``run_async`` and ``DynamicBatcher`` held to the JAX test
  (``tests/test_inference_asp.py:163-200``) on the same net;
  ``ProgramAnalysis.dot_flops`` equal to the JAX count for the MLP and
  the tiny Llama at a static spec;
- ``onnx.export``'s metadata equal to the JAX package's but for
  ``format``;
- the ``.native.json`` of a dynamic signature holds an error and
  ``NativePredictor`` refuses it (no AOTInductor compile runs here: one
  op took 64 s on a CPU host);
- a dynamic dim outside the range export derived raises ValueError;
- the deploy modules import neither JAX nor ``paddle_tpu``.

Every model is built and exported once per module; inputs are numpy
draws from fixed seeds.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import export as jexport

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu import jit as jjit
from paddle_tpu import onnx as jonnx
from paddle_tpu.inference.analysis import ProgramAnalysis as JaxAnalysis
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference, jit, nn, onnx
from paddle_tpu_torch.inference.analysis import ProgramAnalysis
from paddle_tpu_torch.inference.native import NativePredictor
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from torch_parity import cpu_device  # noqa: F401

torch.set_num_threads(1)

ATOL = 1e-4
MLP_SPEC = ([None, 8], "float32")
MLP_STATIC = ([3, 8], "float32")
LLAMA_STATIC = ([2, 8], "int64")


def _jax_mlp():
    paddle.seed(7)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    net.eval()
    return net


def _port_like(jnet):
    """The port's MLP with the JAX net's weights (the same names)."""
    tnet = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    jp, tp = list(jnet.named_parameters()), list(tnet.named_parameters())
    assert [n for n, _ in jp] == [n for n, _ in tp]
    with torch.no_grad():
        for (_, a), (_, b) in zip(jp, tp):
            b.copy_(torch.from_numpy(np.array(a._value)))
    return tnet


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The artifacts of both packages, each model exported once."""
    prev = tdevice._CURRENT[0]
    ptt.set_device("cpu")
    try:
        d = tmp_path_factory.mktemp("deploy")
        jnet = _jax_mlp()
        tnet = _port_like(jnet)
        tnet.train()
        paths = {k: str(d / k) for k in (
            "j_mlp", "t_mlp", "j_mlp_static", "t_mlp_static", "j_llama",
            "t_llama", "t_llama_dyn")}
        jjit.save(jnet, paths["j_mlp"],
                  input_spec=[jjit.InputSpec(*MLP_SPEC)])
        jit.save(tnet, paths["t_mlp"],
                 input_spec=[jit.InputSpec(*MLP_SPEC)])
        trained_after_save = tnet.training
        tnet.eval()
        jjit.save(jnet, paths["j_mlp_static"],
                  input_spec=[jjit.InputSpec(*MLP_STATIC)])
        jit.save(tnet, paths["t_mlp_static"],
                 input_spec=[jit.InputSpec(*MLP_STATIC)])
        paddle.seed(0)
        jm = JaxLlama(JaxLlamaConfig.tiny())
        jm.eval()
        jjit.save(jm, paths["j_llama"],
                  input_spec=[jjit.InputSpec(*LLAMA_STATIC)])
        ptt.seed(3)               # other weights than the JAX Llama's
        tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        jit.save(tm, paths["t_llama"],
                 input_spec=[jit.InputSpec(*LLAMA_STATIC)])
        jit.save(tm, paths["t_llama_dyn"],
                 input_spec=[jit.InputSpec([None, None], "int64")])
        yield {"jnet": jnet, "tnet": tnet, "jm": jm, "tm": tm, "dir": d,
               "trained_after_save": trained_after_save, **paths}
    finally:
        tdevice._CURRENT[0] = prev


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape)


def _x(rows, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, 8)).astype(np.float32)


def test_mlp_save_load_against_jax(art):
    assert art["trained_after_save"]          # save restored train mode
    jl, tl = jjit.load(art["j_mlp"]), jit.load(art["t_mlp"])
    assert tl.n_inputs == jl.n_inputs == 1
    assert tl.eval() is tl
    for rows in (1, 5):
        x = _x(rows, rows)
        got = tl(x)
        np.testing.assert_allclose(got.numpy(), jl(x).numpy(), atol=ATOL)
        assert torch.equal(got, art["tnet"](torch.from_numpy(x)))
        assert torch.equal(tl.forward(torch.from_numpy(x)), got)


def test_llama_save_load_against_jax_and_pdiparams_both_ways(art):
    ids = _ids(tuple(LLAMA_STATIC[0]))
    jl = jjit.load(art["j_llama"])
    want_j = jl(ids).numpy()
    # the port's own artifact: its eager forward, bit for bit
    tl = jit.load(art["t_llama"])
    got_t = tl(ids)
    with torch.no_grad():
        assert torch.equal(got_t, art["tm"](torch.from_numpy(ids)))
    # the JAX package's .pdiparams in the port's artifact
    mixed = str(art["dir"] / "mixed")
    shutil.copy(art["t_llama"] + ".pt2", mixed + ".pt2")
    shutil.copy(art["j_llama"] + ".pdiparams", mixed + ".pdiparams")
    np.testing.assert_allclose(jit.load(mixed)(ids).numpy(), want_j,
                               atol=ATOL)
    # the port's .pdiparams as the JAX TranslatedLayer's inputs
    with open(art["t_llama"] + ".pdiparams", "rb") as f:
        tw = pickle.load(f)
    with open(art["j_llama"] + ".stablehlo", "rb") as f:
        exported = jexport.deserialize(f.read())
    jt = jjit.TranslatedLayer(exported,
                              [jnp.asarray(a) for a in tw["params"]],
                              [jnp.asarray(a) for a in tw["buffers"]])
    np.testing.assert_allclose(jt(ids).numpy(), got_t.numpy(), atol=ATOL)
    assert np.abs(got_t.numpy() - want_j).max() > 1e-2   # other weights
    # names and order: the JAX model's
    meta = tl._meta
    assert meta["params"] == [n for n, _ in art["jm"].named_parameters()]
    assert meta["buffers"] == [n for n, _ in art["jm"].named_buffers()]
    assert meta["buffers"] == ["llama.rope_cos", "llama.rope_sin"]


def test_pdiparams_of_another_shape_raises(art):
    bad = str(art["dir"] / "bad")
    shutil.copy(art["t_mlp"] + ".pt2", bad + ".pt2")
    with open(art["t_mlp"] + ".pdiparams", "rb") as f:
        w = pickle.load(f)
    w["params"][0] = np.zeros((3, 3), np.float32)
    with open(bad + ".pdiparams", "wb") as f:
        pickle.dump(w, f)
    with pytest.raises(ValueError, match="weight 0.weight"):
        jit.load(bad)
    w["params"] = w["params"][1:]
    with open(bad + ".pdiparams", "wb") as f:
        pickle.dump(w, f)
    with pytest.raises(ValueError, match="3 params, the program 4"):
        jit.load(bad)


def test_predictor_async_and_dynamic_batching_against_jax(art):
    jpred = jinference.create_predictor(jinference.Config(art["j_mlp"]))
    pred = inference.create_predictor(inference.Config(art["t_mlp"] + ".pt2"))
    assert pred.get_input_names() == jpred.get_input_names() == ["input_0"]
    x = _x(2, 4)
    # batch 1 through the handles
    for p in (jpred, pred):
        p.get_input_handle("input_0").copy_from_cpu(x[:1])
        assert p.run() is True
    one = pred.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_allclose(
        one, jpred.get_output_handle("output_0").copy_to_cpu(), atol=ATOL)
    assert pred.get_output_handle("output_0").shape() == [1, 4]
    ref = jpred.run([x])[0]
    out = pred.run_async([x]).result(timeout=60)
    np.testing.assert_allclose(out[0], ref, atol=ATOL)
    b = pred.make_batcher(max_batch=4, buckets=(1, 2, 4), timeout_ms=5.0)
    try:
        futs = [b.submit(x[i % 2]) for i in range(6)]
        outs = [f.result(timeout=60) for f in futs]
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o, ref[i % 2], rtol=1e-4, atol=1e-5)
        assert b.rows_served == 6
        assert b.batches_run <= 6
    finally:
        b.close()
    an, jan = pred.analysis(), jpred.analysis()
    assert an.op_histogram()["aten.matmul"] == \
        jan.op_histogram()["dot_general"] == 2
    assert an.dot_flops() == jan.dot_flops() > 0
    assert "inputs" in an.summary() and "aten.matmul" in an.summary()
    assert [s for s, _ in an.input_specs()][:4] == \
        [s for s, _ in jan.input_specs()][:4]
    assert an.constant_count() == 0


def test_dot_flops_equal_jax_at_static_specs(art):
    for j, t in (("j_mlp_static", "t_mlp_static"), ("j_llama", "t_llama")):
        want = JaxAnalysis(art[j]).dot_flops()
        assert ProgramAnalysis(art[t]).dot_flops() == want > 0, t
    an = ProgramAnalysis(art["t_llama"])
    hist = an.op_histogram()
    assert {hist[f"ptt.{k}"] for k in (
        "flash_attention_fwd", "fused_rope_qk", "swiglu")} == {2}
    assert hist["ptt.rms_norm"] == 5
    assert an.constant_count() == 2           # the RoPE tables


def test_onnx_export_metadata_against_jax(art, tmp_path):
    x = _x(2, 9)
    spec = [jit.InputSpec(*MLP_SPEC)]
    j = jonnx.export(art["jnet"], str(tmp_path / "j.onnx"),
                     input_spec=[jjit.InputSpec(*MLP_SPEC)])
    t = onnx.export(art["tnet"], str(tmp_path / "t.onnx"), input_spec=spec)
    assert j.endswith(".stablehlo") and t.endswith(".pt2")
    with open(str(tmp_path / "j.json")) as f:
        jm = json.load(f)
    with open(str(tmp_path / "t.json")) as f:
        tm = json.load(f)
    assert (jm.pop("format"), tm.pop("format")) == ("stablehlo",
                                                     "torch.export")
    assert tm == jm
    fn = onnx.load(t)
    np.testing.assert_allclose(fn(torch.from_numpy(x[:1])).detach().numpy(),
                               art["tnet"](torch.from_numpy(x[:1]))
                               .detach().numpy(), atol=1e-6)
    with pytest.raises(RuntimeError, match="onnx"):
        onnx.export(art["tnet"], str(tmp_path / "o.onnx"), input_spec=spec,
                    export_format="onnx")


def test_native_sidecar_and_refusal(art):
    with open(art["t_mlp"] + ".native.json") as f:
        meta = json.load(f)
    assert "dynamic dims" in meta["error"]
    with pytest.raises(RuntimeError, match="no native program"):
        NativePredictor(art["t_mlp"], device="cpu")
    with open(art["t_mlp_static"] + ".native.json") as f:
        meta = json.load(f)
    assert meta == {"inputs": [{"shape": [3, 8], "dtype": "float32"}],
                    "format": "aoti"}
    with open(art["j_mlp_static"] + ".native.json") as f:
        jmeta = json.load(f)
    if "inputs" in jmeta:
        assert jmeta["inputs"] == meta["inputs"]


def test_dynamic_dims_keep_the_exported_range(art):
    tl = jit.load(art["t_llama_dyn"])
    assert tl._meta["inputs"][0]["range"] == {"0": [2, None], "1": [2, 64]}
    for shape in ((1, 1), (3, 64)):
        ids = _ids(shape, 5)
        with torch.no_grad():
            want = art["tm"](torch.from_numpy(ids))
        assert torch.equal(tl(ids), want)
    with pytest.raises(ValueError, match="input 0 dim 1: size 65"):
        tl(_ids((1, 65)))
    with pytest.raises(ValueError, match="input 0: type float32"):
        tl(np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="expected 1 inputs"):
        tl(_ids((1, 4)), _ids((1, 4)))
    static = jit.load(art["t_llama"])
    with pytest.raises(ValueError, match="dim 0: size 3"):
        static(_ids((3, 8)))


def test_to_static_layer_saves_its_eager_forward(art, tmp_path):
    net = _port_like(art["jnet"])
    net.eval()
    jit.to_static(net)
    static = net.forward
    path = str(tmp_path / "st")
    jit.save(net, path, input_spec=[jit.InputSpec(*MLP_SPEC)])
    assert net.forward is static
    x = _x(3, 11)
    np.testing.assert_allclose(jit.load(path)(x).numpy(),
                               net(torch.from_numpy(x)).detach().numpy(),
                               atol=1e-6)


def test_config_surface():
    cfg = inference.Config("/some/dir/model.pt2")
    assert cfg.model_dir() == "/some/dir/model"
    cfg.set_model("/other/m")
    assert cfg.model_dir() == "/other/m"
    assert cfg.device() == torch.device("cpu")     # the current device
    cfg.enable_use_gpu(device_id=1)
    assert cfg._device == "cuda:1"
    cfg.disable_gpu()
    assert not cfg.use_gpu() and "device=cpu" in cfg.summary()
    with pytest.raises(NotImplementedError, match="TensorRT"):
        cfg.enable_tensorrt_engine()
    for name in ("Float32", "Bfloat16", "Half", "Int8"):
        assert getattr(inference.PrecisionType, name) == \
            getattr(jinference.PrecisionType, name)
    assert "torch" in inference.get_version()


def test_deploy_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys; import paddle_tpu_torch.jit, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.inference.analysis, "
            "paddle_tpu_torch.inference.native, paddle_tpu_torch.onnx; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
