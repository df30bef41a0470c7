"""The port's ``amp.debugging`` against the JAX package's.

- ``check_numerics_guard``: an Inf injected into a parameter of the tiny
  Llama makes both packages raise a ``FloatingPointError`` naming the
  same op (the JAX dispatcher scans each op's output, the port the
  tensors each named op reads: for an Inf that enters through a
  parameter both name the op that consumes it); a clean forward passes;
  the guard restores the flag;
- operator stats over one O1 forward of the tiny Llama: for every op
  name the port counts, the count equals the JAX dispatcher's; the JAX
  names the port does not count are exactly the documented ones
  (``getitem``, ``reshape``: plain tensor operations on the port); the
  counts reach the registry as ``dispatch_op_calls{op=}``;
- ``compare_accuracy``: the same verdict (and the same drift, within the
  float32/bfloat16 rounding the two packages share) on the same
  function of the same inputs.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.framework.flags import get_flag as jget_flag
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import weights
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.framework import get_flag
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

UNCOUNTED_LLAMA = {"getitem", "reshape"}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = weights.from_paddle_tpu_state(
        arrays, LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    return jm, tm, arrays


def _ids():
    return np.random.default_rng(0).integers(0, 128, (2, 12)).astype(
        np.int32)


def _raised_op(fn):
    try:
        fn()
    except FloatingPointError as e:
        msg = str(e)
        return msg.split("'")[1]
    return None


@pytest.mark.parametrize("param,row", [
    ("llama.layers.0.mlp.gate_proj.weight", 3),
    ("llama.embed_tokens.weight", None),
    ("llama.layers.1.input_layernorm.weight", 5),
    ("llama.layers.1.self_attn.o_proj.weight", 0)])
def test_check_numerics_names_the_jax_op(pair, param, row):
    jm, tm, arrays = pair
    ids = _ids()
    bad = arrays[param].copy()
    idx = (int(ids[0, 0]),) if row is None else (row,)
    bad[idx] = np.inf
    jp = dict(jm.named_parameters())[param]
    tp = dict(tm.named_parameters())[param]
    jp.set_value(bad)
    with torch.no_grad():
        tp.copy_(torch.from_numpy(bad))
    try:
        with jdbg.check_numerics_guard():
            want = _raised_op(lambda: jm(paddle.to_tensor(ids)))
        with tdbg.check_numerics_guard():
            got = _raised_op(lambda: tm(torch.from_numpy(ids)))
    finally:
        jp.set_value(arrays[param])
        with torch.no_grad():
            tp.copy_(torch.from_numpy(arrays[param].copy()))
    assert want is not None
    assert got == want
    assert get_flag("FLAGS_check_nan_inf") is False
    assert jget_flag("FLAGS_check_nan_inf") is False
    with tdbg.check_numerics_guard():
        tm(torch.from_numpy(ids))                # clean: no raise


def test_tensor_checker_flag():
    cfg = tdbg.TensorCheckerConfig(enable=True)
    tdbg.enable_tensor_checker(cfg)
    assert get_flag("FLAGS_check_nan_inf") is True
    with pytest.raises(FloatingPointError, match="op 'linear'"):
        tamp.amp_cast("linear", torch.tensor([1.0, float("nan")]))
    tdbg.disable_tensor_checker()
    assert get_flag("FLAGS_check_nan_inf") is False
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    assert get_flag("FLAGS_check_nan_inf") is False
    tamp.amp_cast("linear", torch.tensor([float("inf")]))   # off: passes


def test_operator_stats_equal_jax_on_an_o1_forward(pair):
    jm, tm, _ = pair
    ids = _ids()
    tobs.reset()
    with jdbg.collect_operator_stats():
        with jamp.auto_cast(level="O1"):
            jm(paddle.to_tensor(ids))
        want = jdbg.get_operator_stats()
    with tdbg.collect_operator_stats():
        with tamp.auto_cast(level="O1"):
            tm(torch.from_numpy(ids))
        got = tdbg.get_operator_stats()
    assert got, "the port counted nothing"
    for op, n in got.items():
        assert want.get(op) == n, (op, n, want.get(op))
    assert set(want) - set(got) == UNCOUNTED_LLAMA
    assert {"linear", "rms_norm", "swiglu", "fused_rope", "add",
            "embedding", "scaled_dot_product_attention"} <= set(got)
    snap = tobs.snapshot()["counters"]
    assert snap["dispatch_op_calls{op=linear}"] == got["linear"]
    # collection off: nothing more is counted
    tm(torch.from_numpy(ids))
    assert tdbg.get_operator_stats() == got


@pytest.mark.parametrize("tol", [1e-6, 5e-2])
def test_compare_accuracy_verdict_equals_jax(tol):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 8)).astype(np.float32) * 0.1

    def jrun(dt):
        return paddle.matmul(paddle.to_tensor(a).astype(dt),
                             paddle.to_tensor(b).astype(dt))

    def trun(dt):
        d = getattr(torch, dt)
        return torch.from_numpy(a).to(d) @ torch.from_numpy(b).to(d)

    want = jdbg.compare_accuracy(jrun, rtol=tol, atol=tol, verbose=False)
    got = tdbg.compare_accuracy(trun, rtol=tol, atol=tol, verbose=False)
    assert [r["mismatch"] for r in got] == [r["mismatch"] for r in want]
    assert got[0]["mismatch"] is (tol < 1e-3)
    np.testing.assert_allclose(got[0]["max_abs_diff"],
                               want[0]["max_abs_diff"], rtol=0.5)
