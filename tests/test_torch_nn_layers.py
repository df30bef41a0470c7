"""The port's ``nn`` layers, ``Layer``/``ParamAttr`` and initializers
against the JAX package's, on the CPU.

- ``Layer``'s API (``create_parameter`` defaults, ``register_buffer``
  with persistable=False, ``named_sublayers``/``sublayers``,
  ``set_state_dict``, ``register_forward_post_hook``, ``clear_gradients``,
  ``astype``, ``train``/``eval``) and each layer's state-dict names equal
  to the JAX layer's;
- ``ParamAttr``'s fields reaching the optimizer: the port's SGD step on a
  layer made with a learning-rate multiplier, a regularizer,
  need_clip=False under global-norm clipping and trainable=False equals
  the JAX package's on the same weights and gradients;
- each initializer by its bounds and moments (draws differ by design),
  and its fans on a Linear weight ``[in, out]`` (fan-in dim 0, unlike
  ``torch.nn.init``) and on conv weights; the deterministic ones
  (``Dirac``, ``Bilinear``, ``Assign``, ``Constant``) exactly;
- BatchNorm's running statistics after 3 training steps against JAX
  (momentum 0.9, the biased batch variance), then its eval output;
- every layer's forward (and, for some, its input gradient) against the
  JAX layer's with the JAX weights copied across by name.

Tolerances: float64 1e-10 relative, float32 1e-5 (the convolutions
1e-4); moments within 4 standard errors.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
import paddle_tpu.optimizer as jopt

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.nn import initializer as I
from torch_parity import cpu_device, rng  # noqa: F401

torch.set_num_threads(1)


def _jax_arrays(layer):
    out = {n: np.asarray(p._value) for n, p in layer.named_parameters()}
    for n, b in layer.named_buffers():
        out[n] = np.asarray(b._value)
    return out


def _bridge(jlayer, tlayer):
    weights.from_paddle_tpu_state(_jax_arrays(jlayer), tlayer)
    return tlayer


# -- Layer --

class _Block(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 3, device="cpu")
        self.bn = nn.BatchNorm1D(3, device="cpu")
        self.seq = nn.Sequential(nn.Linear(3, 3, device="cpu"), nn.ReLU())
        self.register_buffer("steps", torch.zeros(()), persistable=False)
        self.register_buffer("scale", torch.ones(3))

    def forward(self, x):
        return self.seq(self.bn(self.fc(x))) * self.scale


class _JBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 3)
        self.bn = jnn.BatchNorm1D(3)
        self.seq = jnn.Sequential(jnn.Linear(3, 3), jnn.ReLU())
        self.register_buffer("steps", paddle.zeros([]), persistable=False)
        self.register_buffer("scale", paddle.ones([3]))


def test_layer_api_and_state_dict_names_equal_jax():
    t, j = _Block(), _JBlock()
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    assert "steps" not in t.state_dict()
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert len(t.sublayers(include_self=True)) == \
        len(j.sublayers(include_self=True))
    assert t.fc.full_name() == "linear"
    # create_parameter: Xavier-normal weight, zero bias, float32
    p = t.create_parameter([400, 300], device="cpu")
    assert p.dtype == torch.float32 and p.requires_grad
    assert abs(float(p.std()) - math.sqrt(2 / 700)) < 4 * math.sqrt(
        2 / 700) / math.sqrt(2 * p.numel())
    assert not bool(t.create_parameter([5], is_bias=True,
                                       device="cpu").any())
    # set_state_dict from numpy arrays: (missing, unexpected)
    arrays = {k: np.full(tuple(v.shape), 0.5, np.float32)
              for k, v in t.state_dict().items() if k != "scale"}
    arrays["nope"] = np.zeros(2)
    missing, unexpected = t.set_state_dict(arrays)
    assert missing == ["scale"] and unexpected == ["nope"]
    assert float(t.fc.weight[0, 0]) == 0.5
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_state_dict({"fc.bias": np.zeros(4, np.float32)})
    # hooks, modes, gradients, types
    h = t.register_forward_post_hook(lambda m, i, o: o * 0 + 7)
    assert torch.all(t(torch.ones(2, 4)) == 7)
    h.remove()
    t.eval()
    assert not any(m.training for m in t.sublayers())
    t.train()
    assert all(m.training for m in t.sublayers())
    t(torch.ones(2, 4)).sum().backward()
    assert t.fc.weight.grad is not None
    t.clear_gradients()
    assert all(p.grad is None for p in t.parameters())
    t.astype("float64")
    assert t.fc.weight.dtype == torch.float64 and \
        t.bn._mean.dtype == torch.float64


def test_containers_are_layers_with_jax_names():
    t = nn.LayerList([nn.Linear(2, 2, device="cpu")])
    t.append(nn.Conv2D(2, 2, 1, device="cpu"))
    j = jnn.LayerList([jnn.Linear(2, 2)])
    j.append(jnn.Conv2D(2, 2, 1))
    assert isinstance(t, nn.Layer) and sorted(t.state_dict()) == \
        sorted(j.state_dict())
    s = nn.Sequential([("a", nn.Linear(2, 2, device="cpu")),
                       ("b", nn.Silu())])
    assert isinstance(s, nn.Layer) and list(s.state_dict()) == \
        ["a.weight", "a.bias"]
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    assert isinstance(pl, nn.Layer) and list(pl.state_dict()) == ["0"]


# -- ParamAttr --

def test_param_attr_fields_reach_the_optimizer_as_in_jax():
    """One SGD step with a learning-rate multiplier on the weight, an L2
    regularizer on the bias, need_clip=False on the weight under
    global-norm clipping: the port's update equals JAX's. trainable=False
    takes no gradient and no update in either package."""
    r = rng(40)
    w0 = r.standard_normal((4, 3)).astype(np.float32)
    b0 = r.standard_normal(3).astype(np.float32)
    x = r.standard_normal((5, 4)).astype(np.float32)

    jl = jnn.Linear(4, 3, weight_attr=jnn.ParamAttr(
        learning_rate=0.5, need_clip=False),
        bias_attr=jnn.ParamAttr(regularizer=paddle.regularizer.L2Decay(0.1)))
    jl.weight.set_value(w0)
    jl.bias.set_value(b0)
    tl = nn.Linear(4, 3, weight_attr=nn.ParamAttr(
        learning_rate=0.5, need_clip=False, name="w"),
        bias_attr=nn.ParamAttr(regularizer=topt.L2Decay(0.1)),
        device="cpu")
    weights.from_paddle_tpu_state({"weight": w0, "bias": b0}, tl)
    assert tl.weight.optimize_attr == {"learning_rate": 0.5}
    assert tl.weight.need_clip is False and tl.weight.param_name == "w"

    jo = jopt.SGD(0.1, parameters=jl.parameters(),
                  grad_clip=jnn.ClipGradByGlobalNorm(0.05))
    to = topt.SGD(0.1, parameters=tl.parameters(),
                  grad_clip=topt.ClipGradByGlobalNorm(0.05))
    jl(paddle.to_tensor(x)).sum().backward()
    jo.step()
    tl(torch.from_numpy(x)).sum().backward()
    to.step()
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight._value), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               np.asarray(jl.bias._value), rtol=1e-5,
                               atol=1e-6)

    frozen = nn.Linear(4, 3, weight_attr=nn.ParamAttr(trainable=False),
                       device="cpu")
    before = frozen.weight.detach().clone()
    o = topt.SGD(0.1, parameters=frozen.parameters())
    frozen(torch.from_numpy(x)).sum().backward()
    o.step()
    assert frozen.weight.grad is None and frozen.weight.trainable is False
    assert torch.equal(frozen.weight.detach(), before)
    jf = jnn.Linear(4, 3, weight_attr=jnn.ParamAttr(trainable=False))
    assert jf.weight.stop_gradient


def test_param_attr_initializer_and_name_forms():
    ptt.seed(2)
    lin = nn.Linear(3, 4, weight_attr=I.Constant(0.25), bias_attr="b",
                    device="cpu")
    assert torch.all(lin.weight == 0.25) and lin.bias.param_name == "b"
    conv = nn.Conv2D(2, 3, 3, weight_attr=nn.ParamAttr(
        initializer=I.Assign(np.ones((3, 2, 3, 3)))), bias_attr=False,
        device="cpu")
    assert torch.all(conv.weight == 1) and conv.bias is None


# -- initializers --

def _moments(t, mean, std, n_sigma=4):
    n = t.numel()
    assert abs(float(t.mean()) - mean) < n_sigma * std / math.sqrt(n)
    assert abs(float(t.std()) - std) < n_sigma * std / math.sqrt(2 * n)


@pytest.mark.parametrize("shape", [(300, 200), (64, 32, 3, 3)])
def test_initializers_fans_bounds_and_moments(shape):
    ptt.seed(11)
    if len(shape) == 2:
        fin, fout = shape[0], shape[1]          # [in, out]: dim 0 is in
    else:
        rec = shape[2] * shape[3]
        fin, fout = shape[1] * rec, shape[0] * rec
    assert I._compute_fans(shape) == JI._compute_fans(shape) == (fin, fout)
    gen = lambda init: init._generate(shape, torch.float32, "cpu")  # noqa
    _moments(gen(I.XavierNormal()), 0.0, math.sqrt(2 / (fin + fout)))
    lim = math.sqrt(6 / (fin + fout))
    u = gen(I.XavierUniform())
    assert float(u.abs().max()) <= lim
    _moments(u, 0.0, lim / math.sqrt(3))
    _moments(gen(I.KaimingNormal()), 0.0, math.sqrt(2 / fin))
    k = gen(I.KaimingUniform(negative_slope=math.sqrt(5),
                             nonlinearity="leaky_relu"))
    klim = math.sqrt(2 / 6) * math.sqrt(3 / fin)
    assert float(k.abs().max()) <= klim
    _moments(k, 0.0, klim / math.sqrt(3))
    _moments(gen(I.Normal(1.0, 2.0)), 1.0, 2.0)
    un = gen(I.Uniform(-3.0, 1.0))
    assert float(un.min()) >= -3.0 and float(un.max()) <= 1.0
    _moments(un, -1.0, 4 / math.sqrt(12))
    tn = gen(I.TruncatedNormal(0.5, 2.0, a=-1.0, b=1.5))
    assert float(tn.min()) >= 0.5 - 2.0 and float(tn.max()) <= 0.5 + 3.0
    bf = I.Normal()._generate(shape, torch.bfloat16, "cpu")
    assert bf.dtype == torch.bfloat16


def test_deterministic_initializers_equal_jax():
    for shape in ((4, 2, 3, 3), (6, 3, 4, 4)):
        got = I.Bilinear()._generate(shape, torch.float32, "cpu")
        want = np.asarray(JI.Bilinear()._generate(shape, "float32"))
        np.testing.assert_array_equal(got.numpy(), want)
        for groups in (1, 2):
            got = I.Dirac(groups)._generate(shape, torch.float32, "cpu")
            want = np.asarray(JI.Dirac(groups)._generate(shape, "float32"))
            np.testing.assert_array_equal(got.numpy(), want)
    v = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(
        I.Assign(v)._generate((2, 3), torch.float64, "cpu").numpy(), v)
    with pytest.raises(ValueError):
        I.Assign(v)._generate((3, 2), torch.float64, "cpu")
    assert torch.all(I.Constant(3.0)._generate((2,), torch.float32,
                                               "cpu") == 3)
    o = I.Orthogonal(2.0)._generate((4, 6), torch.float64, "cpu")
    # drawn and factored in float32, as in JAX, whatever the type
    np.testing.assert_allclose((o @ o.T).numpy(), 4 * np.eye(4),
                               atol=1e-5)
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert I.calculate_gain(nl, p) == JI.calculate_gain(nl, p)
    I.set_global_initializer(I.Constant(1.0))
    assert isinstance(I._global_weight_init, I.Constant)
    I.set_global_initializer(None)
    ptt.seed(9)
    a = I.Normal()._generate((5,), torch.float32, "cpu")
    ptt.seed(9)
    b = I.Normal()._generate((5,), torch.float32, "cpu")
    assert torch.equal(a, b)
    param = torch.nn.Parameter(torch.zeros(3, 3))
    I.Constant(2.0)(param)
    assert torch.all(param == 2)


# -- BatchNorm running statistics --

@pytest.mark.parametrize("cls,shape,fmt", [
    ("BatchNorm2D", (4, 3, 5, 5), "NCHW"),
    ("BatchNorm1D", (8, 3), "NCHW"),
    ("BatchNorm2D", (4, 5, 5, 3), "NHWC"),
])
def test_batchnorm_running_statistics_after_3_steps_equal_jax(cls, shape,
                                                             fmt):
    r = rng(41)
    j = getattr(jnn, cls)(3, data_format=fmt)
    t = _bridge(j, getattr(nn, cls)(3, data_format=fmt, device="cpu",
                                    dtype="float32"))
    for _ in range(3):
        x = (r.standard_normal(shape) * 2 + 1).astype(np.float32)
        got = t(torch.from_numpy(x))
        want = j(paddle.to_tensor(x))
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t._mean.numpy(), np.asarray(j._mean._value),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t._variance.numpy(),
                               np.asarray(j._variance._value), rtol=1e-6,
                               atol=1e-6)
    t.eval()
    j.eval()
    x = r.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               j(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sync_batchnorm_reduces_over_the_shards_and_converts():
    r = rng(42)
    x = r.standard_normal((8, 3, 4, 4)).astype(np.float32)
    whole = nn.BatchNorm2D(3, device="cpu")
    sync = nn.SyncBatchNorm.convert_sync_batchnorm(
        nn.Sequential(nn.BatchNorm2D(3, device="cpu")))[0]
    assert isinstance(sync, nn.SyncBatchNorm)
    want = whole(torch.from_numpy(x))
    got = sync([torch.from_numpy(x[:4]), torch.from_numpy(x[4:])])
    torch.testing.assert_close(torch.cat(got), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sync._variance, whole._variance, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(sync(torch.from_numpy(x)),
                               whole(torch.from_numpy(x)))


# -- every layer's forward against JAX --

def _x(shape, seed=43):
    return rng(seed).standard_normal(shape).astype(np.float32)


X4 = _x((2, 4, 6, 6))
LAYERS = [
    ("Conv1D", (4, 6, 3), {"padding": 1, "stride": 2}, _x((2, 4, 9))),
    ("Conv2D", (4, 6, 3), {"padding": "SAME", "groups": 2}, X4),
    ("Conv3D", (2, 3, 2), {}, _x((1, 2, 4, 4, 4))),
    ("Conv1DTranspose", (4, 3, 3), {"stride": 2}, _x((2, 4, 5))),
    ("Conv2DTranspose", (4, 6, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, X4),
    ("Conv3DTranspose", (2, 2, 2), {"stride": 2}, _x((1, 2, 3, 3, 3))),
    ("GroupNorm", (2, 4), {}, X4),
    ("InstanceNorm2D", (4,), {}, X4),
    ("InstanceNorm1D", (4,), {}, _x((2, 4, 7))),
    ("InstanceNorm3D", (2,), {}, _x((1, 2, 3, 3, 3))),
    ("LocalResponseNorm", (3,), {}, X4),
    ("LayerNorm", ([6, 6],), {}, X4),
    ("RMSNorm", (6,), {}, X4),
    ("BatchNorm", (4,), {"act": "relu"}, X4),
    ("BatchNorm3D", (2,), {}, _x((2, 2, 3, 3, 3))),
    ("AvgPool1D", (3, 2, 1), {}, _x((2, 4, 9))),
    ("AvgPool2D", (3, 2, 1), {"ceil_mode": True}, X4),
    ("AvgPool3D", (2,), {}, _x((1, 2, 4, 4, 4))),
    ("MaxPool1D", (2,), {}, _x((2, 4, 9))),
    ("MaxPool2D", (3, 2, 1), {}, X4),
    ("MaxPool3D", (2,), {}, _x((1, 2, 4, 4, 4))),
    ("AdaptiveAvgPool1D", (3,), {}, _x((2, 4, 9))),
    ("AdaptiveAvgPool2D", (4,), {}, X4),
    ("AdaptiveAvgPool3D", (2,), {}, _x((1, 2, 4, 4, 4))),
    ("AdaptiveMaxPool1D", (3,), {}, _x((2, 4, 9))),
    ("AdaptiveMaxPool2D", ([3, 2],), {}, X4),
    ("AdaptiveMaxPool3D", (2,), {}, _x((1, 2, 4, 4, 4))),
    ("LPPool2D", (2.0, 2), {}, np.abs(X4) + 0.1),
    ("Upsample", (), {"scale_factor": 2}, X4),
    ("UpsamplingBilinear2D", (), {"size": [9, 5]}, X4),
    ("UpsamplingNearest2D", (), {"scale_factor": 1.5}, X4),
    ("PixelShuffle", (2,), {}, X4),
    ("PixelUnshuffle", (2,), {}, X4),
    ("ChannelShuffle", (2,), {}, X4),
    ("Pad2D", ([1, 2, 0, 1],), {"mode": "reflect"}, X4),
    ("ZeroPad2D", ([1, 1, 2, 0],), {}, X4),
    ("Pad1D", ([2, 1],), {"value": 3.0}, _x((2, 4, 9))),
    ("Pad3D", ([1, 0, 0, 1, 1, 1],), {}, _x((1, 2, 3, 3, 3))),
    ("Flatten", (), {}, X4),
    ("Identity", (), {}, X4),
    ("Unfold", ([2, 2],), {"strides": 2}, X4),
    ("Dropout2D", (), {}, X4),
    ("Dropout3D", (), {}, _x((1, 2, 3, 3, 3))),
    ("AlphaDropout", (), {}, X4),
    ("Embedding", (10, 4), {"padding_idx": 0},
     np.array([[1, 0, 3], [9, 2, 0]])),
    ("Linear", (6, 5), {}, X4),
    *[(n, (), {}, X4) for n in (
        "ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Hardswish",
        "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
        "ThresholdedReLU", "LeakyReLU", "ELU", "SELU", "CELU", "Mish",
        "Softplus", "Softsign", "Tanh", "LogSigmoid", "Softmax",
        "LogSoftmax", "GLU")],
    ("Maxout", (2,), {}, X4),
    ("PReLU", (4,), {}, X4),
    ("LeakyReLU", (0.3,), {}, X4),
]
TWO_INPUT = [
    ("CosineSimilarity", (), {"axis": 1}, (_x((4, 5)), _x((4, 5), 44))),
    ("Bilinear", (3, 4, 2), {}, (_x((5, 3)), _x((5, 4), 44))),
    ("Fold", ([4, 5], 2), {}, (_x((2, 12, 12)),)),
]
LOSSES = [
    ("CrossEntropyLoss", (), {}, (_x((6, 5)), np.array([0, 1, 4, 2, 3, 1]))),
    ("MSELoss", (), {}, (_x((4, 3)), _x((4, 3), 44))),
    ("L1Loss", (), {"reduction": "sum"}, (_x((4, 3)), _x((4, 3), 44))),
    ("SmoothL1Loss", (), {}, (_x((4, 3)), _x((4, 3), 44))),
    ("HuberLoss", (), {"delta": 0.5}, (_x((4, 3)), _x((4, 3), 44))),
    ("BCELoss", (), {}, (1 / (1 + np.exp(-_x((4, 3)))),
                         (_x((4, 3), 44) > 0).astype(np.float32))),
    ("BCEWithLogitsLoss", (), {}, (_x((4, 3)),
                                   (_x((4, 3), 44) > 0).astype(np.float32))),
    ("NLLLoss", (), {}, (np.log(np.full((6, 5), 0.2, np.float32)),
                         np.array([0, 1, 4, 2, 3, 1]))),
    ("KLDivLoss", (), {"reduction": "batchmean"},
     (np.log(np.full((4, 3), 1 / 3, np.float32)),
      np.full((4, 3), 1 / 3, np.float32))),
    ("MarginRankingLoss", (), {"margin": 0.2},
     (_x((5,)), _x((5,), 44), np.array([1, -1, 1, 1, -1], np.float32))),
    ("HingeEmbeddingLoss", (), {},
     (_x((5,)), np.array([1, -1, 1, 1, -1], np.float32))),
    ("CosineEmbeddingLoss", (), {},
     (_x((5, 3)), _x((5, 3), 44), np.array([1, -1, 1, 1, -1],
                                           np.float32))),
    ("TripletMarginLoss", (), {}, (_x((5, 3)), _x((5, 3), 44),
                                   _x((5, 3), 45))),
    ("CTCLoss", (), {}, (_x((8, 2, 5)), np.array([[1, 2], [3, 1]]),
                         np.array([8, 6]), np.array([2, 2]))),
]


def _pair(name, args, kw):
    targs = dict(kw)
    if name in ("Linear", "Embedding", "PReLU", "Bilinear") or \
            name.startswith(("Conv", "BatchNorm", "GroupNorm", "Instance",
                             "LayerNorm", "RMSNorm")):
        targs["device"] = "cpu"
    ptt.seed(0)
    paddle.seed(0)
    return getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args,
                                                              **targs)


def _ids(rows):
    return [f"{r[0]}-{i}" for i, r in enumerate(rows)]


@pytest.mark.parametrize("name,args,kw,x", LAYERS, ids=_ids(LAYERS))
def test_layer_forward_matches_jax(name, args, kw, x):
    j, t = _pair(name, args, kw)
    _bridge(j, t)
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    j.eval()
    t.eval()
    want = j(paddle.to_tensor(x)).numpy()
    got = t(torch.from_numpy(x)).detach().numpy()
    tol = 1e-4 if name.startswith("Conv") else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,args,kw,xs", TWO_INPUT + LOSSES,
                         ids=_ids(TWO_INPUT + LOSSES))
def test_multi_input_layer_and_loss_match_jax(name, args, kw, xs):
    j, t = _pair(name, args, kw)
    _bridge(j, t)
    want = j(*map(paddle.to_tensor, xs)).numpy()
    got = t(*map(torch.from_numpy, xs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_and_norm_layer_grads_match_jax():
    """d(sum(out * w))/dx and the parameters' gradients of a
    Conv2D -> GroupNorm -> Conv2DTranspose stack."""
    x = _x((2, 4, 6, 6))
    js = jnn.Sequential(jnn.Conv2D(4, 6, 3, padding=1),
                        jnn.GroupNorm(3, 6),
                        jnn.Conv2DTranspose(6, 2, 2, stride=2))
    ts = _bridge(js, nn.Sequential(nn.Conv2D(4, 6, 3, padding=1,
                                             device="cpu"),
                                   nn.GroupNorm(3, 6, device="cpu"),
                                   nn.Conv2DTranspose(6, 2, 2, stride=2,
                                                      device="cpu")))
    wt = _x((2, 2, 12, 12), 46)
    jx = paddle.to_tensor(x, stop_gradient=False)
    (js(jx) * paddle.to_tensor(wt)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    (ts(tx) * torch.from_numpy(wt)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    jp = dict(js.named_parameters())
    for n, p in ts.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n].grad.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_layer_names_equal_jax():
    """Every layer class the JAX nn exports from its activation, common,
    conv, norm, pooling and loss modules (and the containers and base)
    is the port's."""
    import inspect
    mods = {f"paddle_tpu.nn.layer.{m}" for m in (
        "activation", "common", "conv", "norm", "pooling", "loss",
        "layers")}
    names = [n for n, v in vars(jnn).items()
             if inspect.isclass(v) and v.__module__ in mods]
    assert len(names) > 90
    assert [n for n in names if not hasattr(nn, n)] == []


def _layer_classes():
    import inspect
    mods = {f"paddle_tpu.nn.layer.{m}" for m in (
        "common", "conv", "norm", "pooling", "loss", "layers")}
    return sorted(n for n, v in vars(jnn).items()
                  if inspect.isclass(v) and v.__module__ in mods)


@pytest.mark.parametrize("name", _layer_classes())
def test_layer_signature_matches_jax(name):
    """The constructor takes the JAX layer's parameters (names, defaults,
    kinds), then keyword-only device and dtype."""
    import inspect

    def params(fn):
        # a trailing **kw (the legacy BatchNorm's) follows device and dtype
        return [p for p in inspect.signature(fn).parameters.values()
                if p.name != "self" and p.kind != p.VAR_KEYWORD]
    want = [(p.name, p.default, p.kind)
            for p in params(getattr(jnn, name).__init__)]
    got = params(getattr(nn, name).__init__)
    assert [(p.name, p.default, p.kind) for p in got[:len(want)]] == want
    assert all(p.kind == p.KEYWORD_ONLY and p.name in ("device", "dtype")
               for p in got[len(want):])
