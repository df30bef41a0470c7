"""``paddle_tpu_torch.jit.to_static`` and its knobs, against the JAX
package's ``jit.to_static`` where both compute.

- ``to_static(layer, build_strategy=BuildStrategy(fuse=True))`` on the
  JAX test's Net (a Linear into an RMS norm, here the norm written from
  plain ops): one capture, the norm rewritten onto the kernel's op, the
  output equal to the JAX package's to_static output within 1e-5
  (float32; the kernel's plain version computes the norm with rsqrt
  where the composition takes reciprocal(sqrt)), and the gradients
  reaching the layer's own parameters equal the eager ones (1e-6);
- the plain-op Llama's forward under fusion: one program for repeated
  calls, the architecture's rewrites, logits equal to eager (1e-5);
- without fusion: a capture with no rewrite, outputs bit-equal to eager;
- a branch on a tensor's value, a random draw, and an autograd Function
  (the mpu collectives' ``Split``) each break that signature to eager,
  counted and warned, with eager's results; after ``_SIG_BREAK_CAP``
  broken signatures the function runs eagerly without capturing;
- ``amp.auto_cast`` under capture gives eager's casts (O1 and O2: the
  same dtypes and bit-equal values);
- ``InputSpec``, ``not_to_static``, ``enable_to_static``, and the error
  paths of ``jit.save`` / ``jit.load`` (the deploy path itself is
  ``test_torch_deploy.py``'s).

Inputs are numpy draws from fixed seeds.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import jit as jjit
from paddle_tpu.compiler import BuildStrategy as JaxBuildStrategy

from paddle_tpu_torch import amp, jit, weights
from paddle_tpu_torch.compiler import BuildStrategy
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability.metrics import REGISTRY as REG

ATOL = 1e-5


def counter(name, pattern=None):
    c = REG.get(name, {"pattern": pattern} if pattern else None)
    return c.value if c is not None else 0


def _audit():
    spec = importlib.util.spec_from_file_location(
        "fusion_audit_torch", os.path.join(os.path.dirname(__file__), "..",
                                           "fusion_audit_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Net(torch.nn.Module):
    """The JAX test's Net: Linear(16, 32) into an RMS norm of 32, the norm
    written from plain ops."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(16, 32)
        self.norm_w = torch.nn.Parameter(torch.ones(32))

    def forward(self, x):
        h = self.lin(x)
        ms = torch.mean(torch.square(h), dim=-1, keepdim=True)
        return (h * torch.reciprocal(torch.sqrt(ms + 1e-6))) * self.norm_w


def test_to_static_build_strategy_fuse_matches_jax():
    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = jnn.Linear(16, 32)
            self.norm = jnn.RMSNorm(32)

        def forward(self, x):
            return self.norm(self.lin(x))
    paddle.seed(1)
    jnet = JNet()
    jnet.eval()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jst = jjit.to_static(jnet.forward,
                         build_strategy=JaxBuildStrategy(fuse=True))
    want = jst(paddle.to_tensor(x)).numpy()

    net = Net()
    with torch.no_grad():   # the JAX Linear's [in, out] weight
        net.lin.weight.copy_(torch.from_numpy(
            np.array(jnet.lin.weight._value)).t())
        net.lin.bias.copy_(torch.from_numpy(np.array(
            jnet.lin.bias._value)))
        net.norm_w.copy_(torch.from_numpy(np.array(
            jnet.norm.weight._value)))
    tx = torch.from_numpy(x)
    ref = net(tx)
    ref.sum().backward()
    want_g = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad()
    before = counter("compiler_rewrites_total", "rms_norm")
    progs = counter("compiler_programs_total")
    st = jit.to_static(net, build_strategy=BuildStrategy(fuse=True))
    got = st(tx)
    got.sum().backward()
    assert counter("compiler_rewrites_total", "rms_norm") == before + 1
    st(tx)
    assert counter("compiler_programs_total") == progs + 1
    assert len(net.forward.programs()) == 1
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                   atol=1e-6, err_msg=n)


def test_plain_llama_forward_fused_once():
    fa = _audit()
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, ffn=64, seq=32)
    model = weights.init_random_(fa.PlainLlama(cfg), 0).eval()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 64, (2, 16)))
    with torch.no_grad():
        want = model(ids)
        pats = ("attention", "rms_norm", "swiglu", "rope")
        before = {p: counter("compiler_rewrites_total", p) for p in pats}
        st = jit.to_static(model.forward,
                           build_strategy=BuildStrategy(fuse=True))
        outs = [st(ids) for _ in range(3)]
    assert len(st.programs()) == 1
    assert {p: counter("compiler_rewrites_total", p) - before[p]
            for p in pats} == {"attention": 2, "rms_norm": 5, "swiglu": 2,
                               "rope": 4}
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)


def test_without_fusion_captures_and_equals_eager():
    net = Net()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 16)).astype(np.float32))
    want = net(x)
    before = counter("compiler_rewrites_total", "rms_norm")
    st = jit.to_static(net.forward, build_strategy=BuildStrategy(fuse=False))
    got = st(x)
    assert torch.equal(got, want)
    assert len(st.programs()) == 1
    assert counter("compiler_rewrites_total", "rms_norm") == before


def test_data_dependent_branch_breaks_to_eager():
    def fn(x):
        if x.sum() > 0:        # Python control flow on a computed value
            return x * 2.0
        return x - 1.0
    st = jit.to_static(fn)
    before = counter("compiler_graph_breaks_total")
    x = torch.ones(3)
    with pytest.warns(UserWarning, match="graph break"):
        out = st(x)
    assert torch.equal(out, x * 2.0)
    assert torch.equal(st(-x), -x - 1.0)      # same signature: eager
    assert st.graph_breaks == 1
    assert counter("compiler_graph_breaks_total") == before + 1
    assert st.programs() == []


def test_graph_break_cap_turns_the_function_eager():
    def fn(x):
        return x * 2.0 if x.sum() > 0 else x
    st = jit.to_static(fn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in range(1, st._SIG_BREAK_CAP + 1):
            st(torch.ones(n))
    assert st._all_eager and st.graph_breaks == st._SIG_BREAK_CAP
    before = counter("compiler_graph_breaks_total")
    assert torch.equal(st(torch.ones(20)), torch.full((20,), 2.0))
    assert counter("compiler_graph_breaks_total") == before


def test_random_draw_and_autograd_function_break_to_eager():
    def drop(x):
        return F.dropout(x, 0.5, training=True)

    def split(x):
        a, b = mp_ops.Split.apply(x, -1, [torch.device("cpu")] * 2)
        return a + b
    x = torch.ones(4, 8)
    for fn, check in ((drop, lambda o: o.shape == x.shape),
                      (split, lambda o: torch.equal(o, x[:, :4] * 2))):
        st = jit.to_static(fn)
        with pytest.warns(UserWarning, match="graph break"):
            out = st(x)
        assert check(out) and st.graph_breaks == 1 and st.programs() == []


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_under_capture_gives_eager_casts(level):
    net = Net()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 16)).astype(np.float32))

    def fn(x):
        h = F.linear(x, net.lin.weight.t(), net.lin.bias)
        return F.rms_norm(h, net.norm_w), F.layer_norm(h, 32)
    st = jit.to_static(fn, build_strategy=BuildStrategy(fuse=True))
    with amp.auto_cast(level=level, dtype="bfloat16"):
        want = fn(x)
        got = st(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert len(st.programs()) == 1
    got32 = st(x)                 # amp off: another signature
    assert got32[0].dtype == torch.float32 and len(st.programs()) == 2


def test_knobs_and_deploy_path(tmp_path):
    spec = jit.InputSpec([None, 16], "float32", name="x")
    assert spec.shape == (None, 16) and "InputSpec" in repr(spec)

    @jit.not_to_static
    def eager_only(x):
        return x + 1
    st = jit.to_static(eager_only)
    assert torch.equal(st(torch.zeros(2)), torch.ones(2))
    assert st.programs() == []
    st2 = jit.to_static(lambda x: x * 3)
    jit.enable_to_static(False)
    try:
        st2(torch.ones(2))
        assert st2.programs() == []
    finally:
        jit.enable_to_static(True)
    st2(torch.ones(2))
    assert len(st2.programs()) == 1
    jit.set_code_level(10)
    jit.set_verbosity(1)
    with jit.ignore_module([torch.nn]):
        pass
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(Net(), str(tmp_path / "x"))
    with pytest.raises(TypeError, match="Layer"):
        jit.save(lambda x: x, str(tmp_path / "x"), input_spec=[spec])
    with pytest.raises(FileNotFoundError):
        jit.load(str(tmp_path / "missing"))
    assert isinstance(jit.TranslatedLayer, type)
