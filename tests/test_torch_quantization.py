"""The port's quantization (``paddle_tpu_torch.quantization``) against the
JAX package's ``paddle_tpu.quantization``, on the CPU.

- every observer and quanter over the same three batches (seeded numpy,
  the range growing so the histograms re-bin): scales equal (floats to
  1e-12, the histograms' edges exact, their counts exact), outputs equal;
- the straight-through estimator: forward the dequantized codes, gradient
  the identity, in both packages;
- ``weight_quantize``'s codes and scales bit-equal (int8 per channel,
  int4 grouped), ``weight_only_linear`` to 1e-5, ``cal_kl_threshold``
  equal on the same histogram;
- QAT and PTQ on a tiny Llama (weights bridged from the JAX model) and on
  a small conv net: the same number of swapped layers in both packages,
  PTQ's outputs equal to the float model's and its scales JAX's,
  the outputs within 1e-3 of the largest logit (a value within float32
  rounding of a half-code boundary may take the neighbouring code in the
  other package: one code step, ~1e-2 of the scale, moves the logits by
  ~1e-4), and far from the float model's (the quantization is no no-op);
  the calibrated observers' state carried across (``weights.
  observer_state``) gives equal outputs on a new batch; the QAT
  gradients within 1e-3 of their largest;
- ``quantize_pass`` through both compilers on the same function: the same
  rewrite count (the linear products, never the batched attention
  product), outputs to 1e-5, and equal to the eager ``QuantedLinear``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.quantization as JQ
from paddle_tpu import compiler as jcompiler
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.metrics import REGISTRY as JREG

import paddle_tpu_torch as ptt
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability.metrics import REGISTRY as TREG
from torch_parity import cpu_device, rng  # noqa: F401

torch.set_num_threads(1)


def _batches(seed=0, shape=(6, 16)):
    r = rng(seed)
    return [(r.standard_normal(shape) * s).astype(np.float32)
            for s in (1.0, 2.5, 0.5)]


def _scale_np(v):
    if v is None or isinstance(v, float):
        return v
    return np.asarray(v.numpy() if hasattr(v, "numpy") and not
                      isinstance(v, torch.Tensor) else v.detach().numpy())


OBSERVERS = [
    ("AbsmaxObserver", {}), ("EMAObserver", {"moving_rate": 0.8}),
    ("FakeQuanterWithAbsMax", {}), ("FakeQuanterWithAbsMax",
                                    {"quant_bits": 4}),
    ("ChannelWiseAbsmaxObserver", {"quant_axis": 1}),
    ("FakeChannelWiseQuanter", {"quant_axis": 0}),
    ("HistObserver", {"bins_count": 64, "percent": 0.99}),
    ("KLObserver", {"bins_count": 256}),
]


@pytest.mark.parametrize("name,kw", OBSERVERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OBSERVERS)])
def test_observer_matches_jax(name, kw):
    jo, to = getattr(JQ, name)(**kw), getattr(TQ, name)(**kw)
    for b in _batches():
        want = jo(paddle.to_tensor(b))
        got = to(torch.from_numpy(b))
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want.numpy()), rtol=1e-6,
                                   atol=1e-7)
    js, ts = _scale_np(jo.scales()), _scale_np(to.scales())
    np.testing.assert_allclose(ts, js, rtol=1e-12)
    for attr in ("_hist", "_edges"):
        if hasattr(jo, attr):
            np.testing.assert_array_equal(getattr(to, attr),
                                          getattr(jo, attr))
    if name.startswith("FakeChannel"):
        x = _batches(1)[0]
        np.testing.assert_allclose(
            to.quant_dequant(torch.from_numpy(x)).numpy(),
            np.asarray(jo.quant_dequant(paddle.to_tensor(x)).numpy()),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4])
def test_straight_through_estimator(bits):
    x = _batches(2)[1]
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_(True)
    jout = JQ.fake_quant_dequant(jx, 3.0, bits)
    tout = TQ.fake_quant_dequant(tx, 3.0, bits)
    qmax = 2 ** (bits - 1) - 1
    q = np.clip(np.round(x / np.float32(3.0) * qmax), -qmax, qmax)
    # equal up to the last bit: x + (q - x) rounds once more than q
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.numpy()), rtol=3e-7)
    np.testing.assert_allclose(tout.detach().numpy(),
                               q * np.float32(3.0) / qmax, rtol=1e-6)
    w = rng(3).standard_normal(x.shape).astype(np.float32)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), w)
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())


@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("weight_only_int4", 64),
                                        ("weight_only_int8", 32)])
def test_weight_quantize_codes_and_scales_bit_equal(algo, group):
    w = rng(4).standard_normal((256, 96)).astype(np.float32)
    w[:, 5] = 0.0                                       # a zero channel
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo=algo,
                                group_size=group)
    tq, ts = TQ.weight_quantize(torch.from_numpy(w), algo=algo,
                                group_size=group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == (96, 256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    qmax = 127 if algo.endswith("int8") else 7
    assert np.abs(tq.numpy()).max() == qmax
    x = rng(5).standard_normal((3, 256)).astype(np.float32)
    b = rng(6).standard_normal((96,)).astype(np.float32)
    jy = JQ.weight_only_linear(paddle.to_tensor(x), jq, paddle.to_tensor(b),
                               js, group_size=group)
    ty = TQ.weight_only_linear(torch.from_numpy(x), tq, torch.from_numpy(b),
                               ts, group_size=group)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy.numpy()),
                               rtol=1e-5, atol=1e-5)
    # the dequantized product is close to the float one
    rel = np.abs(ty.numpy() - (x @ w + b)).max() / np.abs(x @ w).max()
    assert rel < (0.02 if qmax == 127 else 0.2)


def test_cal_kl_threshold_equal():
    r = rng(7)
    for bits in (8, 4):
        hist = np.histogram(np.abs(r.standard_normal(20000)), bins=512)[0]
        assert TQ.cal_kl_threshold(hist, 0.01, bits) == \
            JQ.cal_kl_threshold(hist, 0.01, bits)


# -- QAT / PTQ on models ------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny())
    jm.eval()
    arrays = {n: np.asarray(p._value, np.float32)
              for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    weights.from_paddle_tpu_state(arrays, tm)
    return jm, tm


def _ids(seed, shape=(2, 12)):
    return rng(seed).integers(0, 128, shape).astype(np.int64)


def _count(model, cls):
    return sum(isinstance(m, cls) for _, m in weights._sublayers(model))


def _close(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_qat_llama_matches_jax_and_changes_the_output(llama_pair):
    jm, tm = llama_pair
    jq = JQ.QAT(JQ.QuantConfig()).quantize(jm)
    tq = TQ.QAT(TQ.QuantConfig()).quantize(tm)
    n = _count(tq, TQ.QuantedLinear)
    assert n == _count(jq, JQ.QuantedLinear) == 2 * 7 + 1
    assert _count(tm, TQ.QuantedLinear) == 0            # a deep copy
    # the bridge keeps the JAX names (inner.weight) both ways
    assert set(tq.state_dict()) == set(jq.state_dict())
    ids = _ids(1)
    want = np.asarray(jq(paddle.to_tensor(ids)).numpy())
    got = tq(torch.from_numpy(ids)).detach().numpy()
    flt = tm(torch.from_numpy(ids)).detach().numpy()
    _close(got, want, 1e-3)
    assert np.abs(got - flt).max() > 20 * 1e-3 * np.abs(want).max()
    # the calibrated scales carry over: a fresh port QAT model loaded with
    # JAX's observer state gives JAX's output on a new batch
    fresh = TQ.QAT(TQ.QuantConfig()).quantize(tm)
    state = weights.observer_state(jq)
    assert len(state) == 2 * n and all(
        isinstance(s["_scale"], float) for s in state.values())
    weights.load_observer_state(fresh, state)
    ids2 = _ids(2)
    want2 = np.asarray(jq(paddle.to_tensor(ids2)).numpy())
    _close(fresh(torch.from_numpy(ids2)).detach().numpy(), want2, 1e-3)
    # and the port's trained state loads back into JAX
    jq2 = JQ.QAT(JQ.QuantConfig()).quantize(jm)
    jq2.set_state_dict({k: paddle.to_tensor(v) for k, v in
                        weights.to_numpy_state(tq).items()})
    for name, attrs in weights.observer_state(tq).items():
        setattr(dict(jq2.named_sublayers())[name], "_scale", attrs["_scale"])
    _close(np.asarray(jq2(paddle.to_tensor(ids2)).numpy()),
           tq(torch.from_numpy(ids2)).detach().numpy(), 1e-3)


@pytest.mark.parametrize("kind", ["AbsmaxObserver", "HistObserver"])
def test_ptq_llama_matches_jax(llama_pair, kind):
    """PTQ's observers pass the activations through (the outputs stay the
    float model's) and calibrate the same scales: Absmax to 1e-5, Hist
    within two of its bins (an activation a float32 rounding apart can
    land in the neighbouring bin)."""
    jm, tm = llama_pair
    bins = 256
    kw = {"bins_count": bins} if kind == "HistObserver" else {}
    jq = JQ.PTQ(JQ.QuantConfig(getattr(JQ, kind)(**kw),
                               JQ.AbsmaxObserver())).quantize(jm)
    tq = TQ.PTQ(TQ.QuantConfig(getattr(TQ, kind)(**kw),
                               TQ.AbsmaxObserver())).quantize(tm)
    assert _count(tq, TQ.QuantedLinear) == _count(jq, JQ.QuantedLinear)
    for seed in (5, 6):
        ids = _ids(seed)
        got = tq(torch.from_numpy(ids)).detach().numpy()
        want = np.asarray(jq(paddle.to_tensor(ids)).numpy())
        _close(got, want, 1e-5)
        np.testing.assert_array_equal(
            got, tm(torch.from_numpy(ids)).detach().numpy())
    jstate, tstate = weights.observer_state(jq), weights.observer_state(tq)
    assert set(jstate) == set(tstate)
    for name in jstate:
        j = float(np.asarray(jstate[name]["_scale"]))
        t = float(np.asarray(tstate[name]["_scale"]))
        width = j / bins if kind == "HistObserver" and \
            name.endswith("activation_quanter") else 0.0
        assert abs(t - j) <= 2 * width + 1e-5 * abs(j), (name, t, j)


def test_qat_llama_gradients_match_jax(llama_pair):
    jm, tm = llama_pair
    jq = JQ.QAT(JQ.QuantConfig()).quantize(jm)
    tq = TQ.QAT(TQ.QuantConfig()).quantize(tm)
    jq.train()
    tq.train()
    ids = _ids(3)
    w = rng(4).standard_normal((2, 12, 128)).astype(np.float32)
    (jq(paddle.to_tensor(ids)) * paddle.to_tensor(w)).sum().backward()
    (tq(torch.from_numpy(ids)) * torch.from_numpy(w)).sum().backward()
    jg = dict(jq.named_parameters())
    for name, p in tq.named_parameters():
        _close(p.grad.numpy(), np.asarray(jg[name].grad.numpy()), 1e-3)


def _conv_pair():
    paddle.seed(1)
    jnet = paddle.nn.Sequential(
        paddle.nn.Conv2D(3, 8, 3, padding=1), paddle.nn.ReLU(),
        paddle.nn.Conv2D(8, 4, 3, stride=2), paddle.nn.Flatten(),
        paddle.nn.Linear(4 * 3 * 3, 5))
    tnet = tnn.Sequential(
        tnn.Conv2D(3, 8, 3, padding=1, device="cpu"), tnn.ReLU(),
        tnn.Conv2D(8, 4, 3, stride=2, device="cpu"), tnn.Flatten(),
        tnn.Linear(4 * 3 * 3, 5, device="cpu"))
    weights.from_paddle_tpu_state(
        {n: np.asarray(p._value, np.float32)
         for n, p in jnet.named_parameters()}, tnet)
    return jnet, tnet


@pytest.mark.parametrize("mode", ["QAT", "PTQ-absmax", "PTQ-hist", "PTQ-kl"])
def test_conv_net_qat_and_ptq_match_jax(mode):
    jnet, tnet = _conv_pair()
    if mode == "QAT":
        jq = JQ.QAT(JQ.QuantConfig()).quantize(jnet)
        tq = TQ.QAT(TQ.QuantConfig()).quantize(tnet)
    else:
        kind = {"absmax": "AbsmaxObserver", "hist": "HistObserver",
                "kl": "KLObserver"}[mode.split("-")[1]]
        jq = JQ.PTQ(JQ.QuantConfig(getattr(JQ, kind)(),
                                   getattr(JQ, kind)())).quantize(jnet)
        tq = TQ.PTQ(TQ.QuantConfig(getattr(TQ, kind)(),
                                   getattr(TQ, kind)())).quantize(tnet)
    assert _count(tq, TQ.QuantedConv2D) == _count(jq, JQ.QuantedConv2D) == 2
    assert _count(tq, TQ.QuantedLinear) == _count(jq, JQ.QuantedLinear) == 1
    r = rng(8)
    for _ in range(3):                  # calibration / training batches
        x = r.standard_normal((4, 3, 7, 7)).astype(np.float32)
        want = np.asarray(jq(paddle.to_tensor(x)).numpy())
        got = tq(torch.from_numpy(x)).detach().numpy()
        _close(got, want, 1e-4 if mode != "QAT" else 1e-3)
    jstate, tstate = weights.observer_state(jq), weights.observer_state(tq)
    assert set(jstate) == set(tstate) and len(tstate) == 6
    for name in jstate:
        for attr, v in jstate[name].items():
            np.testing.assert_allclose(np.asarray(tstate[name][attr],
                                                  np.float64),
                                       np.asarray(v, np.float64),
                                       rtol=1e-6, err_msg=f"{name}.{attr}")
    if mode == "QAT":
        flt = tnet(torch.from_numpy(x)).detach().numpy()
        assert np.abs(got - flt).max() > 1e-3 * np.abs(flt).max()


# -- the compiler pass ----------------------------------------------------------

def _rewrites(reg):
    c = reg.get("compiler_rewrites_total", {"pattern": "quant_linear"})
    return c.value if c is not None else 0


@pytest.mark.parametrize("weight_only", [False, True])
def test_quantize_pass_matches_jax(weight_only):
    import jax
    import jax.numpy as jnp
    r = rng(9)
    w1 = r.standard_normal((16, 32)).astype(np.float32) * 0.3
    w2 = r.standard_normal((32, 16)).astype(np.float32) * 0.3
    x = r.standard_normal((2, 4, 16)).astype(np.float32)

    def make(mm, tr, softmax, t):
        W1, W2 = t(w1), t(w2)

        def fn(x):
            h = x @ W1                                   # linear
            a = softmax(mm(h, tr(h)))                    # batched: no match
            return mm(a, h) @ W2                         # linear
        return fn

    jfn = make(jnp.matmul, lambda v: jnp.swapaxes(v, 1, 2),
               lambda v: jax.nn.softmax(v, axis=-1), jnp.asarray)
    tfn = make(torch.matmul, lambda v: v.transpose(1, 2),
               lambda v: torch.softmax(v, -1), torch.from_numpy)
    jb, tb = _rewrites(JREG), _rewrites(TREG)
    jpm = jcompiler.PassManager([JQ.quantize_pass(weight_only=weight_only),
                                 "dce"])
    tpm = tcompiler.PassManager([TQ.quantize_pass(weight_only=weight_only),
                                 "dce"])
    want = np.asarray(jax.jit(jcompiler.optimize(
        jfn, name="q", pass_manager=jpm))(jnp.asarray(x)))
    topt = tcompiler.optimize(tfn, name="q", pass_manager=tpm)
    got = topt(torch.from_numpy(x)).numpy()
    assert _rewrites(TREG) - tb == _rewrites(JREG) - jb == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = tfn(torch.from_numpy(x)).numpy()
    assert np.abs(got - plain).max() > 1e-4
    (gm,) = topt.programs.values()
    assert sum(n.target is torch.ops.aten.mm.default
               for n in gm.graph.nodes) == 2


def test_quantize_pass_equals_quanted_linear():
    """The pass's segment is QuantedLinear's on the live tensors."""
    lin = tnn.Linear(16, 32, device="cpu")
    x = torch.from_numpy(rng(10).standard_normal((4, 16)).astype(np.float32))
    ref = TQ.QAT(TQ.QuantConfig()).quantize(lin)(x)
    w, b = lin.weight.detach(), lin.bias.detach()
    pm = tcompiler.PassManager([TQ.quantize_pass(), "dce"])
    got = tcompiler.optimize(lambda v: v @ w + b, name="ql",
                             pass_manager=pm)(x)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    assert "quant_linear" not in tcompiler.rewrites.DEFAULT_PATTERNS
