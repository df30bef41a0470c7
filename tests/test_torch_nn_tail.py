"""``nn``'s tail in the port against the JAX package, on the CPU:

- every op of ``nn/functional/tail.py`` (the small losses,
  ``pairwise_distance``, ``margin_cross_entropy``,
  ``adaptive_log_softmax_with_loss``) at the top level, outputs and the
  gradients of a fixed weighted sum against JAX's tape (float64, 1e-10
  relative); the plain functions (``zeropad2d``, ``lp_pool1d``,
  ``max_unpool1d``, ``sparse_attention``) and the in-place activations
  (``relu_`` ...) of ``nn.functional``; the random ones
  (``class_center_sample``, ``feature_alpha_dropout``) by what they must
  hold;
- the packed flash entry points on the plain path: ``flash_attn_qkvpacked``
  and ``flash_attn_varlen_qkvpacked`` equal the JAX functions (float32,
  2e-5 absolute), and their gradients equal plain softmax attention's
  (the JAX ``flash_attention`` op does not take gradients in eager mode);
- every layer of ``nn/layer/tail.py``'s ``__all__`` against the JAX layer
  with its weights carried across (float32, 1e-5);
- ``nn.utils``: ``weight_norm`` / ``remove_weight_norm`` and
  ``spectral_norm``, their state-dict names (``weight_g``, ``weight_v``,
  ``weight_orig``, ``weight_u``), outputs in train and eval mode and the
  gradients of g, v and orig (float32, 1e-5); ``parameters_to_vector`` /
  ``vector_to_parameters``;
- ``clip_grad_norm_`` (2 and inf, with its 1e-6) and ``clip_grad_value_``
  on the same gradients as JAX's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn, weights
from paddle_tpu_torch.nn import functional as F
from torch_parity import (assert_same, check, check_grad,  # noqa: F401
                          cpu_device, rng, to_np)

torch.set_num_threads(1)

R = np.random.default_rng(20)
A = R.standard_normal((4, 3))
B = R.standard_normal((4, 3))
POS = R.uniform(0.5, 2.0, (4, 3))
SIGN = np.where(R.standard_normal((4, 3)) > 0, 1.0, -1.0)
BIN = (R.uniform(size=(4, 3)) > 0.5).astype(np.float64)
LAB5 = R.integers(0, 5, (4,)).astype(np.int64)
X5 = R.standard_normal((4, 5))
PROB5 = np.exp(X5) / np.exp(X5).sum(-1, keepdims=True)
COS = R.uniform(-0.9, 0.9, (4, 5))
W5 = R.uniform(0.5, 1.5, (5,))
COUNTS = R.integers(0, 4, (4, 3)).astype(np.float64)

CASES = [
    ("gaussian_nll_loss", (A, B, POS), {}),
    ("gaussian_nll_loss", (A, B, POS), {"full": True, "reduction": "sum"}),
    ("gaussian_nll_loss", (A, B, POS * 1e-8), {"reduction": "none"}),
    ("poisson_nll_loss", (A, COUNTS), {}),
    ("poisson_nll_loss", (POS, COUNTS), {"log_input": False, "full": True,
                                         "reduction": "none"}),
    ("soft_margin_loss", (A, SIGN), {}),
    ("soft_margin_loss", (A, SIGN), {"reduction": "none"}),
    ("multi_label_soft_margin_loss", (A, BIN), {}),
    ("multi_label_soft_margin_loss", (A, BIN), {"weight": POS,
                                                "reduction": "sum"}),
    ("multi_margin_loss", (X5, LAB5), {}),
    ("multi_margin_loss", (X5, LAB5), {"p": 2, "margin": 0.5,
                                       "weight": W5, "reduction": "none"}),
    ("triplet_margin_with_distance_loss", (A, B, POS), {}),
    ("triplet_margin_with_distance_loss", (A, B, POS),
     {"swap": True, "margin": 2.0, "reduction": "none"}),
    ("dice_loss", (PROB5, LAB5[:, None]), {}),
    ("pairwise_distance", (A, B), {}),
    ("pairwise_distance", (A, B), {"p": 1.0, "keepdim": True}),
    ("pairwise_distance", (A, B), {"p": float("inf")}),
    ("margin_cross_entropy", (COS, LAB5), {}),
    ("margin_cross_entropy", (COS, LAB5), {"margin1": 0.9, "margin2": 0.2,
                                           "margin3": 0.1, "scale": 16.0,
                                           "return_softmax": True,
                                           "reduction": "none"}),
]


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_tail_op_matches_jax(name, args, kwargs):
    check(name, args, kwargs)


@pytest.mark.parametrize("name,args,kwargs",
                         [c for c in CASES if c[0] != "dice_loss"],
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)
                              if c[0] != "dice_loss"])
def test_tail_op_grads_match_jax(name, args, kwargs):
    check_grad(name, args, kwargs, diff=(0,))


def test_dice_loss_grad():
    check_grad("dice_loss", (PROB5, LAB5[:, None]), diff=(0,))


def test_adaptive_log_softmax_with_loss_layer_and_op():
    """The layer's names equal the JAX layer's. The JAX layer itself
    raises once it has tail clusters (its dispatcher leaves the tail
    weights, Parameters nested in tuples, unwrapped: ROADMAP "Health of
    the reference"), so the port is held to the JAX op's body on the same
    arrays, its loss and the loss's gradients by ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.registry import OP_TABLE as JOP
    paddle.seed(1)
    j = jnn.AdaptiveLogSoftmaxWithLoss(8, 10, [4, 7], div_value=2.0,
                                       head_bias=True)
    t = nn.AdaptiveLogSoftmaxWithLoss(8, 10, [4, 7], div_value=2.0,
                                      head_bias=True)
    names = [n for n, _ in t.named_parameters()]
    assert names == [n for n, _ in j.named_parameters()] == [
        "head_weight", "head_bias", "tail_proj_0", "tail_out_0",
        "tail_proj_1", "tail_out_1"]
    arrays = {n: np.asarray(p._value) for n, p in j.named_parameters()}
    weights.from_paddle_tpu_state(arrays, t)
    x = rng(2).standard_normal((6, 8)).astype(np.float32)
    lab = np.array([0, 3, 4, 6, 7, 9], np.int64)
    with pytest.raises(TypeError):
        j(paddle.to_tensor(x), paddle.to_tensor(lab))
    fn = JOP["adaptive_log_softmax_with_loss"]["fn"]

    def jloss(ws):
        return fn(jnp.asarray(x), jnp.asarray(lab), ws["head_weight"],
                  [(ws["tail_proj_0"], ws["tail_out_0"]),
                   (ws["tail_proj_1"], ws["tail_out_1"])], [4, 7],
                  head_bias=ws["head_bias"])
    jws = {n: jnp.asarray(a) for n, a in arrays.items()}
    jout, jl = jloss(jws)
    jgrads = jax.grad(lambda w: jloss(w)[1])(jws)
    to, tl = t(torch.from_numpy(x), torch.from_numpy(lab))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    tl.backward()
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_class_center_sample_holds_its_contract():
    lab = torch.tensor([3, 7, 3, 11, 0], dtype=torch.int64)
    ptt.seed(5)
    new, sampled = ptt.class_center_sample(lab, 20, 8)
    ptt.seed(5)
    again = ptt.class_center_sample(lab, 20, 8)
    assert torch.equal(sampled, again[1]) and torch.equal(new, again[0])
    assert sampled.tolist() == sorted(set(sampled.tolist()))
    assert len(sampled) == 8 and {0, 3, 7, 11} <= set(sampled.tolist())
    assert torch.equal(sampled[new], lab)
    jnew, jsampled = paddle.class_center_sample(paddle.to_tensor(
        lab.numpy()), 20, 8)
    assert len(to_np(jsampled)) == 8 and np.array_equal(
        to_np(jsampled)[to_np(jnew)], lab.numpy())


def test_feature_alpha_dropout():
    x = torch.from_numpy(rng(3).standard_normal((4, 6, 5)).astype(
        np.float32))
    assert F.feature_alpha_dropout(x, 0.3, training=False) is x
    ptt.seed(2)
    y = F.feature_alpha_dropout(x, 0.3)
    alpha, p = -1.7580993408473766, 0.3
    a = 1 / np.sqrt((alpha ** 2 * p + 1) * (1 - p))
    b = -a * alpha * p
    kept = torch.isclose(y, a * x + b, atol=1e-6).all(-1)
    dropped = torch.isclose(y, torch.full_like(y, a * alpha + b),
                            atol=1e-6).all(-1)
    assert bool((kept | dropped).all()) and bool(kept.any()) and \
        bool(dropped.any())
    ptt.seed(2)
    assert torch.equal(y, nn.FeatureAlphaDropout(0.3)(x))


def _both(fn_name, *args, **kw):
    j = getattr(JF, fn_name)(*[paddle.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args], **kw)
    t = getattr(F, fn_name)(*[torch.from_numpy(a.copy()) if isinstance(
        a, np.ndarray) else a for a in args], **kw)
    return t, j


def test_zeropad2d_lp_pool1d_max_unpool1d():
    x4 = rng(4).standard_normal((2, 3, 4, 5))
    t, j = _both("zeropad2d", x4, [1, 2, 0, 3])
    assert_same(to_np(t), to_np(j))
    x3 = rng(5).uniform(0.1, 2.0, (2, 3, 8))
    t, j = _both("lp_pool1d", x3, 2.0, 3, stride=2)
    assert_same(to_np(t), to_np(j))
    jo, ji = JF.max_pool1d(paddle.to_tensor(x3), 2, return_mask=True)
    to, ti = F.max_pool1d(torch.from_numpy(x3), 2, return_mask=True)
    t = F.max_unpool1d(to, ti, 2)
    j = JF.max_unpool1d(jo, ji, 2)
    assert_same(to_np(t), to_np(j))


@pytest.mark.parametrize("act,kw", [("relu", {}), ("tanh", {}),
                                    ("softmax", {"axis": -1}), ("elu", {}),
                                    ("hardtanh", {}), ("leaky_relu", {}),
                                    ("thresholded_relu", {})])
def test_inplace_activations_write_into_their_input(act, kw):
    x = rng(6).standard_normal((3, 4))
    t = torch.from_numpy(x.copy())
    out = getattr(F, act + "_")(t, **kw)
    want = getattr(JF, act)(paddle.to_tensor(x), **kw)
    assert out is t
    assert_same(to_np(t), to_np(want))


def _ref_attention(q, k, v, causal):
    """Plain softmax attention over [B, S, H, D] (float32)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
    return (torch.softmax(s, -1) @ vh).transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_qkvpacked(causal):
    qkv = rng(7).standard_normal((2, 16, 3, 2, 8)).astype(np.float32)
    t, _ = F.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)
    j, _ = JF.flash_attn_qkvpacked(paddle.to_tensor(qkv), causal=causal)
    np.testing.assert_allclose(t.numpy(), to_np(j), atol=2e-5)
    a = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qkv).requires_grad_(True)
    w = torch.from_numpy(rng(8).standard_normal(t.shape).astype(np.float32))
    (F.flash_attn_qkvpacked(a, causal=causal)[0] * w).sum().backward()
    (_ref_attention(b[:, :, 0], b[:, :, 1], b[:, :, 2], causal) * w).sum() \
        .backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=2e-5)


def test_flash_attn_varlen_qkvpacked():
    cu = np.array([0, 5, 12, 20], np.int32)
    qkv = rng(9).standard_normal((20, 3, 2, 8)).astype(np.float32)
    t = F.flash_attn_varlen_qkvpacked(torch.from_numpy(qkv),
                                      torch.from_numpy(cu),
                                      torch.from_numpy(cu), 8, 8,
                                      causal=True)
    j = JF.flash_attn_varlen_qkvpacked(paddle.to_tensor(qkv),
                                       paddle.to_tensor(cu),
                                       paddle.to_tensor(cu), 8, 8,
                                       causal=True)
    np.testing.assert_allclose(t.numpy(), to_np(j), atol=2e-5)
    a = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(qkv).requires_grad_(True)
    w = torch.from_numpy(rng(10).standard_normal(t.shape).astype(
        np.float32))
    (F.flash_attn_varlen_qkvpacked(a, cu, cu, 8, 8, causal=True) * w) \
        .sum().backward()
    ref = torch.cat([_ref_attention(*(b[None, s:e, i] for i in range(3)),
                                    True)[0]
                     for s, e in zip(cu[:-1], cu[1:])])
    (ref * w).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=2e-5)


def test_sparse_attention_restricted_to_the_csr_pattern():
    r = rng(11)
    b, h, s, d = 1, 2, 4, 8
    q, k, v = (r.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    # row 2 of the second head stores no logit: its output is 0
    offs = np.array([[[0, 2, 3, 5, 6], [0, 1, 3, 3, 5]]], np.int32)
    cols = np.array([[[0, 1, 1, 0, 2, 3], [0, 0, 1, 2, 3, 0]]], np.int32)
    t = F.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v, offs,
                                                           cols)))
    j = JF.sparse_attention(*(paddle.to_tensor(a) for a in (q, k, v, offs,
                                                            cols)))
    np.testing.assert_allclose(t.numpy(), to_np(j), rtol=1e-5, atol=1e-6)
    assert not np.any(t.numpy()[0, 1, 2])


# -- the layers --

def _bridge(j, t):
    arrays = {n: np.asarray(p._value) for n, p in j.named_parameters()}
    assert sorted(arrays) == sorted(n for n, _ in t.named_parameters())
    weights.from_paddle_tpu_state(arrays, t)


def _run_layer(j, t, *inputs, tol=1e-5):
    _bridge(j, t)
    jo = j(*[paddle.to_tensor(a) for a in inputs])
    to = t(*[torch.from_numpy(a.copy()) for a in inputs])
    jl = jo if isinstance(jo, (list, tuple)) else [jo]
    tl = to if isinstance(to, (list, tuple)) else [to]
    for g, w in zip(tl, jl):
        assert_same(to_np(g), to_np(w), tol=(tol, tol))


F32 = np.float32
X = rng(12).standard_normal((4, 3)).astype(F32)
Y = rng(13).standard_normal((4, 3)).astype(F32)
PX = rng(14).uniform(0.5, 2.0, (4, 3)).astype(F32)

LAYER_CASES = [
    ("GaussianNLLLoss", (), {}, (X, Y, PX)),
    ("PoissonNLLLoss", (), {"reduction": "sum"},
     (X, np.round(PX * 2).astype(F32))),
    ("SoftMarginLoss", (), {}, (X, np.sign(Y).astype(F32))),
    ("MultiLabelSoftMarginLoss", (), {}, (X, (Y > 0).astype(F32))),
    ("MultiMarginLoss", (), {"reduction": "none"},
     (X, np.array([0, 2, 1, 1], np.int64))),
    ("TripletMarginWithDistanceLoss", (), {"swap": True}, (X, Y, PX)),
    ("PairwiseDistance", (), {"p": 3.0}, (X, Y)),
    ("Softmax2D", (), {}, (rng(15).standard_normal((2, 3, 4, 4))
                           .astype(F32),)),
    ("Unflatten", (1, [2, 3]), {}, (rng(16).standard_normal((2, 6, 4))
                                    .astype(F32),)),
    ("ZeroPad1D", ([1, 2],), {}, (rng(17).standard_normal((2, 3, 5))
                                  .astype(F32),)),
    ("ZeroPad3D", ([1, 0, 2, 1, 0, 1],), {},
     (rng(18).standard_normal((1, 2, 3, 3, 3)).astype(F32),)),
    ("LPPool1D", (2.0, 2), {}, (rng(19).uniform(0.1, 1.0, (2, 3, 8))
                                .astype(F32),)),
    ("FeatureAlphaDropout", (0.4,), {}, (X,)),
    ("FractionalMaxPool2D", ([3, 3],), {"random_u": 0.3},
     (rng(20).standard_normal((1, 2, 7, 7)).astype(F32),)),
    ("FractionalMaxPool3D", ([2, 2, 2],), {"random_u": 0.6},
     (rng(21).standard_normal((1, 2, 5, 5, 5)).astype(F32),)),
]


@pytest.mark.parametrize("cls,args,kwargs,inputs", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_tail_layer_matches_jax(cls, args, kwargs, inputs):
    j = getattr(jnn, cls)(*args, **kwargs)
    t = getattr(nn, cls)(*args, **kwargs)
    if cls == "FeatureAlphaDropout":
        j.eval()
        t.eval()
    _run_layer(j, t, *inputs)


def test_rnnt_and_hsigmoid_loss_layers():
    r = rng(22)
    logits = r.standard_normal((2, 4, 3, 5)).astype(F32)
    labels = np.array([[1, 2], [3, 0]], np.int32)
    il = np.array([4, 3], np.int32)
    ll = np.array([2, 1], np.int32)
    _run_layer(jnn.RNNTLoss(blank=0), nn.RNNTLoss(blank=0), logits, labels,
               il, ll, tol=1e-4)
    paddle.seed(3)
    feats = r.standard_normal((4, 6)).astype(F32)
    lab = np.array([0, 3, 5, 6], np.int64)
    _run_layer(jnn.HSigmoidLoss(6, 7), nn.HSigmoidLoss(6, 7), feats, lab)


@pytest.mark.parametrize("cls,pool", [("MaxUnPool1D", "max_pool1d"),
                                      ("MaxUnPool2D", "max_pool2d"),
                                      ("MaxUnPool3D", "max_pool3d")])
def test_max_unpool_layers(cls, pool):
    n = int(cls[-2])
    x = rng(23).standard_normal((1, 2) + (4,) * n).astype(F32)
    jo, ji = getattr(JF, pool)(paddle.to_tensor(x), 2, return_mask=True)
    to, ti = getattr(F, pool)(torch.from_numpy(x), 2, return_mask=True)
    assert_same(to_np(ti), to_np(ji))
    j = getattr(jnn, cls)(2)(jo, ji)
    t = getattr(nn, cls)(2)(to, ti)
    assert_same(to_np(t), to_np(j))


def test_spectral_norm_layer():
    paddle.seed(4)
    j = jnn.SpectralNorm([4, 6], dim=0, power_iters=2)
    t = nn.SpectralNorm([4, 6], dim=0, power_iters=2)
    assert not t.weight_u.requires_grad and not t.weight_v.requires_grad
    _run_layer(j, t, rng(24).standard_normal((4, 6)).astype(F32))


def test_layer_dict_and_parameter_dict():
    d = nn.LayerDict({"a": nn.Linear(2, 3), "b": nn.ReLU()})
    d["c"] = nn.Tanh()
    assert list(d.keys()) == ["a", "b", "c"] and len(d) == 3 and "b" in d
    assert isinstance(d.pop("b"), nn.ReLU) and list(d) == ["a", "c"]
    assert [n for n, _ in d.named_parameters()] == ["a.weight", "a.bias"]
    jd = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.ReLU()})
    jd["c"] = jnn.Tanh()
    jd.pop("b")
    assert [n for n, _ in jd.named_parameters()] == ["a.weight", "a.bias"]
    d.update([("z", nn.Linear(3, 1))])
    assert list(d.keys())[-1] == "z"
    d.clear()
    assert len(d) == 0
    p = nn.ParameterDict({"w": torch.nn.Parameter(torch.ones(2))})
    p["v"] = torch.nn.Parameter(torch.zeros(3))
    assert list(p.keys()) == ["w", "v"] and len(p) == 2 and "v" in p
    assert sorted(p.state_dict()) == ["v", "w"]


def test_every_jax_tail_name_is_on_the_port():
    from paddle_tpu.nn.layer import tail as jtail
    assert set(jtail.__all__) <= set(dir(nn))
    assert len(jtail.__all__) == 26
    for name in ("zeropad2d", "lp_pool1d", "max_unpool1d",
                 "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
                 "sparse_attention", "gather_tree", "sequence_mask",
                 "relu_", "thresholded_relu_"):
        assert hasattr(F, name) and hasattr(JF, name), name


# -- nn.utils --

def _linear_pair(seed=5):
    paddle.seed(seed)
    j = jnn.Linear(4, 3)
    t = nn.Linear(4, 3)
    _bridge(j, t)
    return j, t


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_names_outputs_grads_and_removal(dim):
    j, t = _linear_pair()
    jnn.utils.weight_norm(j, dim=dim)
    nn.utils.weight_norm(t, dim=dim)
    names = [n for n, _ in t.named_parameters()]
    assert names == [n for n, _ in j.named_parameters()] == [
        "bias", "weight_v", "weight_g"]
    assert tuple(t.weight_g.shape) == tuple(j.weight_g.shape) == (
        (1,) if dim is None else (t.weight_v.shape[dim],))
    x = rng(25).standard_normal((5, 4)).astype(F32)
    jo = j(paddle.to_tensor(x))
    to = t(torch.from_numpy(x))
    assert_same(to_np(to), to_np(jo), tol=(1e-5, 1e-6))
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    jp = dict(j.named_parameters())
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), to_np(jp[n].grad),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    jnn.utils.remove_weight_norm(j)
    nn.utils.remove_weight_norm(t)
    assert sorted(n for n, _ in t.named_parameters()) == ["bias", "weight"]
    np.testing.assert_allclose(t.weight.detach().numpy(),
                               to_np(j.weight), rtol=1e-6, atol=1e-7)


def test_weight_norm_on_a_conv():
    paddle.seed(6)
    j, t = jnn.Conv2D(2, 3, 3), nn.Conv2D(2, 3, 3)
    _bridge(j, t)
    jnn.utils.weight_norm(j)
    nn.utils.weight_norm(t)
    assert tuple(t.weight_g.shape) == (3,)
    x = rng(26).standard_normal((1, 2, 5, 5)).astype(F32)
    assert_same(to_np(t(torch.from_numpy(x))),
                to_np(j(paddle.to_tensor(x))), tol=(1e-5, 1e-6))


def test_spectral_norm_names_train_eval_and_grads():
    j, t = _linear_pair(7)
    jnn.utils.spectral_norm(j, n_power_iterations=2)
    nn.utils.spectral_norm(t, n_power_iterations=2)
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()] == ["bias", "weight_orig"]
    assert "weight_u" in t.state_dict() and "weight_u" in j.state_dict()
    np.testing.assert_allclose(t.weight_u.numpy(), to_np(j.weight_u),
                               rtol=1e-6)
    x = rng(27).standard_normal((5, 4)).astype(F32)
    for train in (True, True, False):
        for m in (j, t):
            m.train() if train else m.eval()
        jo = j(paddle.to_tensor(x))
        to = t(torch.from_numpy(x))
        assert_same(to_np(to), to_np(jo), tol=(1e-5, 1e-6))
    np.testing.assert_allclose(t.weight_u.numpy(), to_np(j.weight_u),
                               rtol=1e-5, atol=1e-6)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    np.testing.assert_allclose(t.weight_orig.grad.numpy(),
                               to_np(j.weight_orig.grad), rtol=1e-4,
                               atol=1e-6)


def test_parameters_to_vector_and_back():
    j, t = _linear_pair(8)
    jv = jnn.utils.parameters_to_vector(j.parameters())
    tv = nn.utils.parameters_to_vector(t.parameters())
    assert_same(to_np(tv), to_np(jv))
    nn.utils.vector_to_parameters(tv * 2, t.parameters())
    jnn.utils.vector_to_parameters(jv * 2, j.parameters())
    for (n, p), (_, q) in zip(t.named_parameters(), j.named_parameters()):
        assert_same(to_np(p.detach()), to_np(q))


@pytest.mark.parametrize("clip", [("norm", 2.0), ("norm", float("inf")),
                                  ("norm_small", 2.0), ("value", 0.05)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_clip_grad(clip):
    j, t = _linear_pair(9)
    x = rng(28).standard_normal((5, 4)).astype(F32)
    (j(paddle.to_tensor(x)) ** 2).sum().backward()
    (t(torch.from_numpy(x)) ** 2).sum().backward()
    kind, v = clip
    if kind == "value":
        jnn.clip_grad_value_(list(j.parameters()), v)
        nn.clip_grad_value_(list(t.parameters()), v)
        assert nn.utils.clip_grad_value_ is nn.clip_grad_value_
    else:
        mx = 1e3 if kind == "norm_small" else 0.5     # no clip / a clip
        jt = jnn.clip_grad_norm_(list(j.parameters()), mx, norm_type=v)
        tt = nn.utils.clip_grad_norm_(list(t.parameters()), mx,
                                      norm_type=v)
        np.testing.assert_allclose(float(tt), float(to_np(jt)), rtol=1e-6)
    for (n, p), (_, q) in zip(t.named_parameters(), j.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), to_np(q.grad),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    assert float(nn.clip_grad_norm_(list(nn.Linear(2, 2).parameters()),
                                     1.0)) == 0.0     # no gradients
