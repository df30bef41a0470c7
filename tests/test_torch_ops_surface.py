"""The port's op surface as a whole, against the JAX package's:

- coverage: every name the JAX package's creation, math, manipulation,
  reduce, logic, linalg, activation, fused, extra, detection, legacy and
  fused inference modules, ``tensor_tail``, ``fft``, ``signal``,
  ``nn.functional``'s common, conv, pooling, norm, loss, attention and
  tail modules, the rnn layers' module, ``vision.ops``,
  ``quantization``, the MoE layer's module and ``geometric`` put in
  ``OP_TABLE`` (read by
  each entry's ``fn.__module__``) is an attribute of ``paddle_tpu_torch``
  or of its ``fft``/``signal``/``linalg`` namespace, and the port's
  top-level ``_`` names equal the JAX package's;
- no patching: importing ``paddle_tpu_torch`` (in a fresh interpreter)
  leaves ``dir(torch.Tensor)`` as it was;
- ROADMAP §C.1's repair: for one program written from surface calls, the
  port's ``amp.debugging`` operator stats equal the JAX dispatcher's;
  ``FLAGS_check_nan_inf`` names the surface op whose output a NaN reaches
  (and stays quiet where an op reads a NaN and returns finite values, as
  the JAX dispatcher's output scan does); under ``auto_cast`` O1 and O2
  the program's output types equal the JAX package's, with the casts
  inside the ops' gradients.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fft  # noqa: F401
import paddle_tpu.incubate  # noqa: F401  (the MoE and geometric ops)
import paddle_tpu.linalg  # noqa: F401
import paddle_tpu.nn.layer.rnn  # noqa: F401
import paddle_tpu.signal  # noqa: F401
import paddle_tpu.quantization  # noqa: F401
import paddle_tpu.vision.ops  # noqa: F401
from paddle_tpu import amp as jamp
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.incubate.distributed import moe_layer as jmoe
from paddle_tpu.ops.registry import OP_TABLE as JOP_TABLE

import paddle_tpu_torch as ptt
import paddle_tpu_torch.incubate  # noqa: F401  (the MoE and geometric ops)
import paddle_tpu_torch.nn  # noqa: F401  (registers its ops)
import paddle_tpu_torch.quantization.quant  # noqa: F401
import paddle_tpu_torch.vision.ops  # noqa: F401
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.incubate.distributed import moe_layer as tmoe
from paddle_tpu_torch.ops.registry import OP_TABLE
from torch_parity import SWEEP, cpu_device, rng  # noqa: F401

torch.set_num_threads(1)
# the MoE balance loss registers its op at its first call, in both packages
jmoe.load_balance_loss(paddle.zeros([2, 2]))
tmoe.load_balance_loss(torch.zeros(2, 2))

SLICE_MODULES = {f"paddle_tpu.ops.impl.{m}" for m in (
    "creation", "math", "manipulation", "reduce", "logic", "linalg",
    "activation", "fused", "extra", "detection", "misc_legacy",
    "sampling_legacy", "fused_inference")} | {
    "paddle_tpu.tensor_tail", "paddle_tpu.fft", "paddle_tpu.signal"} | {
    f"paddle_tpu.nn.functional.{m}" for m in (
        "common", "conv", "pooling", "norm", "loss", "attention",
        "tail")} | {"paddle_tpu.nn.layer.rnn", "paddle_tpu.vision.ops",
                    "paddle_tpu.quantization",
                    "paddle_tpu.incubate.distributed.moe_layer",
                    "paddle_tpu.geometric"}
# left for a later slice: nothing (sdp_kernel only raises in JAX)
LATER = set()


def test_every_jax_op_of_the_slice_is_on_the_port():
    names = sorted(n for n, e in JOP_TABLE.items()
                   if e["fn"].__module__ in SLICE_MODULES)
    assert len(names) > 500
    missing = [n for n in names if n != "sdp_kernel" and not any(
        hasattr(ns, n) for ns in (ptt, ptt.fft, ptt.signal, ptt.linalg))]
    assert missing == []
    ops_only = set(OP_TABLE) - set(JOP_TABLE)
    assert ops_only == set(), ops_only
    # what the port lacks is from modules outside the slice (LATER) and
    # whatever other JAX modules a process has imported
    left = {e["fn"].__module__ for n, e in JOP_TABLE.items()
            if n != "sdp_kernel" and not any(
                hasattr(ns, n) for ns in (ptt, ptt.fft, ptt.signal))}
    assert not left & SLICE_MODULES, left & SLICE_MODULES


def test_later_ops_are_what_the_port_lacks_and_the_sweep_covers_the_rest():
    """No JAX op module is left for later (LATER is empty: the fused
    inference ops came with the quantization, MoE and geometric ones);
    every op the port has (nn.functional's with its tail, the rnn op,
    vision.ops, the legacy, detection and fused inference ops, the
    quantization, MoE and geometric ops among them) runs in the sweep,
    which passes on the CPU against itself."""
    assert LATER == set()
    later = [n for n, e in JOP_TABLE.items() if e["fn"].__module__ in LATER]
    assert later == []
    assert set(OP_TABLE) <= set(SWEEP.first_cases())
    out = SWEEP.sweep("cpu")
    assert out["ops"] == len(OP_TABLE) and out["failed"] == {}


def test_inplace_names_equal_jax():
    def trailing(mod):
        return {n for n in dir(mod) if n.endswith("_")
                and not n.startswith("_")}
    assert trailing(ptt) == trailing(paddle)


def test_import_adds_no_attribute_to_torch_tensor():
    code = ("import json, torch; before = sorted(dir(torch.Tensor)); "
            "import paddle_tpu_torch as p; p.set_device('cpu'); "
            "p.add_(torch.ones(2), 1.0); "
            "print(json.dumps([sorted(dir(torch.Tensor)) == before, "
            "'jax' in __import__('sys').modules]))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    unchanged, imported_jax = json.loads(out.stdout.strip().splitlines()[-1])
    assert unchanged and not imported_jax


R = rng(12)
X = R.standard_normal((4, 8)).astype(np.float32)
W = (R.standard_normal((8, 8)) * 0.3).astype(np.float32)
G = R.uniform(0.5, 1.5, (8,)).astype(np.float32)


def _program(ns, x, w, g):
    """A small block written from surface calls only."""
    h = ns.matmul(x, w)
    h = ns.fused_rms_norm(h, g, 1e-6)
    a, b = ns.split(h, 2, axis=-1)
    s = ns.swiglu(a, b)
    s = ns.reshape(ns.concat([s, s], axis=-1), [4, 8])
    y = ns.add(ns.multiply(s, 0.5), x)
    y = ns.softmax(y, axis=-1)
    return ns.mean(ns.exp(ns.log(ns.add(y, 1.0))))


def _both(level=None):
    jargs = [paddle.to_tensor(v, stop_gradient=False) for v in (X, W, G)]
    targs = [torch.from_numpy(v.copy()).requires_grad_(True)
             for v in (X, W, G)]
    if level is None:
        return _program(paddle, *jargs), _program(ptt, *targs), jargs, targs
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        jo = _program(paddle, *jargs)
    with tamp.auto_cast(level=level, dtype="bfloat16"):
        to = _program(ptt, *targs)
    return jo, to, jargs, targs


def test_operator_stats_of_a_surface_program_equal_jax():
    with jdbg.collect_operator_stats():
        _program(paddle, *[paddle.to_tensor(v) for v in (X, W, G)])
        want = jdbg.get_operator_stats()
    with tdbg.collect_operator_stats():
        _program(ptt, *[torch.from_numpy(v.copy()) for v in (X, W, G)])
        got = tdbg.get_operator_stats()
    assert got == want
    assert got["fused_rms_norm"] == 1 and "rms_norm" not in got


def test_check_nan_inf_names_the_surface_op():
    xs = X.copy()
    xs[1, 2] = np.nan

    def raised(fn):
        try:
            fn()
        except FloatingPointError as e:
            return str(e).split("'")[1]
        return None

    with jdbg.check_numerics_guard():
        want = raised(lambda: _program(
            paddle, *[paddle.to_tensor(v) for v in (xs, W, G)]))
        jclean = raised(lambda: paddle.nan_to_num(paddle.to_tensor(xs)))
    with tdbg.check_numerics_guard():
        got = raised(lambda: _program(
            ptt, *[torch.from_numpy(v.copy()) for v in (xs, W, G)]))
        tclean = raised(lambda: ptt.nan_to_num(torch.from_numpy(xs)))
        log_neg = raised(lambda: ptt.log(torch.tensor([-1.0])))
    assert got == want == "matmul"
    assert tclean is None and jclean is None
    assert log_neg == "log"


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_output_types_equal_jax(level):
    jo, to, jargs, targs = _both(level)
    jd = np.asarray(jo.numpy()).dtype.name
    td = str(to.dtype).replace("torch.", "")
    assert td == jd
    np.testing.assert_allclose(float(to.float()), float(jo.astype(
        "float32").numpy()), rtol=2e-2)
    (jg,) = paddle.grad(jo, [jargs[1]])
    (tg,) = torch.autograd.grad(to, [targs[1]])
    assert str(tg.dtype).replace("torch.", "") == \
        np.asarray(jg.numpy()).dtype.name == "float32"
    # the intermediate types, op by op, as the JAX dispatcher casts
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        jm = paddle.matmul(jargs[0], jargs[1])
        js = paddle.softmax(jargs[0])
    with tamp.auto_cast(level=level, dtype="bfloat16"):
        tm = ptt.matmul(targs[0], targs[1])
        ts = ptt.softmax(targs[0])
    for t, j in ((tm, jm), (ts, js)):
        assert str(t.dtype).replace("torch.", "") == \
            np.asarray(j.numpy()).dtype.name
