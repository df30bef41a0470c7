"""The port's runtime flags and top-level names against the JAX package's.

- every flag that the JAX package defines once its modules are imported
  (``framework/flags.py``, the flash block sizes, ``kernel_backend``,
  ``fused_lm_head_ce``, ``comm_timeout_s``) exists in the port under the
  same name and default; each is set and read back in both packages, and
  an unknown name raises in both;
- ``FLAGS_cudnn_deterministic`` reaches ``torch.backends.cudnn``
  (deterministic on, benchmark cleared; off again), and
  ``FLAGS_benchmark`` makes each surface op wait for its outputs;
- ``dir(paddle_tpu)`` of a fresh process against ``paddle_tpu_torch``:
  equal, less the names absent by design (``OWED``, each with its
  reason; ROADMAP §A owes none there any more); ``ParamAttr``,
  ``CustomPlace``, ``flops``, ``inference`` and ``onnx`` are top-level
  names, and ``flops`` returns what the JAX package's returns;
- ``utils``, ``hub`` and ``regularizer`` are top-level modules whose
  public names (and ``utils.cpp_extension``'s) equal the JAX package's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
import paddle_tpu.ops.pallas.flash_attention  # noqa: F401  (flash_block_*)
import paddle_tpu.ops.primitive.core  # noqa: F401  (kernel_backend)
import paddle_tpu.models.llama  # noqa: F401  (fused_lm_head_ce)
import paddle_tpu.distributed.watchdog  # noqa: F401  (comm_timeout_s)

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.ops import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names of the JAX package's top level that the port has by design never
# (nothing of ROADMAP §A is owed there any more)
OWED = {
    "core": "by design (the JAX Tensor and dispatcher)",
    "TPUPlace": "by design (no TPU)",
    "annotations": "by design (a __future__ import, not an API)",
}


def _new_value(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 3
    if isinstance(v, float):
        return v + 0.5
    return v + "_set"


def test_every_jax_flag_is_a_port_flag_with_its_default():
    assert set(tflags._FLAGS) == set(jflags._FLAGS)
    for name in jflags._FLAGS:
        assert tflags._META[name]["default"] == \
            jflags._META[name]["default"], name


def test_every_flag_sets_and_reads_in_both_packages():
    jold, told = dict(jflags._FLAGS), dict(tflags._FLAGS)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    want = {f"FLAGS_{n}": _new_value(v) for n, v in jold.items()}
    try:
        for pkg in (paddle, ptt):
            pkg.set_flags(want)
            assert pkg.get_flags(list(want)) == want
            for name, v in want.items():
                assert pkg.get_flags(name) == {name: v}
            with pytest.raises(ValueError, match="unknown flag"):
                pkg.set_flags({"FLAGS_no_such_flag": 1})
    finally:
        jflags._FLAGS.update(jold)
        tflags._FLAGS.update(told)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn


def test_cudnn_deterministic_reaches_torch_backends():
    old = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    prev = tflags.get_flag("cudnn_deterministic")
    try:
        torch.backends.cudnn.benchmark = True
        ptt.set_flags({"FLAGS_cudnn_deterministic": True})
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        ptt.set_flags({"FLAGS_cudnn_deterministic": False})
        assert not torch.backends.cudnn.deterministic
    finally:
        tflags._FLAGS["cudnn_deterministic"] = prev
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def test_benchmark_flag_waits_after_each_surface_op(monkeypatch):
    seen = []
    monkeypatch.setattr(registry, "_sync_outputs", seen.append)
    x = torch.ones(3)
    ptt.add(x, x)
    assert seen == []
    ptt.set_flags({"FLAGS_benchmark": True})
    try:
        out = ptt.add(x, x)
        ptt.multiply(x, x)
    finally:
        ptt.set_flags({"FLAGS_benchmark": False})
    assert len(seen) == 2 and torch.equal(seen[0], out)


def test_top_level_namespace_matches_jax_less_owed_names():
    code = ("import json, paddle_tpu, paddle_tpu_torch as p\n"
            "miss = []\n"
            "for n in dir(paddle_tpu):\n"
            "    if n.startswith('_'): continue\n"
            "    try: getattr(p, n)\n"
            "    except AttributeError: miss.append(n)\n"
            "print(json.dumps(miss))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    missing = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert missing == set(OWED), (sorted(missing - set(OWED)),
                                  sorted(set(OWED) - missing))


def test_new_top_level_names():
    from paddle_tpu_torch import device, nn
    assert ptt.ParamAttr is nn.ParamAttr
    assert ptt.inference.Config is not None
    assert callable(ptt.onnx.export)
    place = ptt.CustomPlace("gpu", 1)
    assert place.is_custom_place() and place.is_gpu_place()
    assert place.get_device_id() == 1 and place.custom_type == "gpu"
    assert isinstance(place, device.Place)
    jnet = paddle.nn.Linear(4, 2)
    tnet = nn.Linear(4, 2, device="cpu")
    assert ptt.flops(tnet, [1, 4]) == paddle.flops(jnet, [1, 4]) == 0


def _public(mod):
    """A module's public names, less the modules it imported."""
    import types
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("name", ["utils", "hub", "regularizer"])
def test_utils_hub_regularizer_top_level_names_match_jax(name):
    jmod, tmod = getattr(paddle, name), getattr(ptt, name)
    assert tmod.__name__ == f"paddle_tpu_torch.{name}"
    assert _public(tmod) == _public(jmod)
    if name == "utils":
        assert tmod.dlpack.__name__ == "paddle_tpu_torch.utils.dlpack"
        assert {n for n in dir(tmod.cpp_extension) if not n.startswith("_")} \
            == {n for n in dir(jmod.cpp_extension) if not n.startswith("_")}
