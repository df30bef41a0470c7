"""The port's functional and layer surface against the JAX package's.

Each port function and layer constructor is bound against its JAX
counterpart with ``inspect.signature``: the same parameters in the same
order with the same defaults, up to and including JAX's last one, and any
parameter the port adds (``generator``, ``device``, ``dtype``)
keyword-only after them. Then the features that came with the repaired
signatures, on numpy-seeded float32 inputs, against the JAX package
(the new layers' and functionals' values are in ``test_torch_gpt.py``,
``test_torch_bert.py``, ``test_torch_transformer.py`` and
``test_torch_incubate.py``):
``rms_norm`` with bias and a leading ``begin_norm_axis``, ``swiglu`` of one
tensor, ``cross_entropy`` with class weights, soft labels, label smoothing
and another axis, ``Linear``'s default bias, ``Embedding``'s
``padding_idx`` (value and gradient), and ``fused_feedforward`` with the
activations JAX takes by ``jax.nn`` name.

Tolerances: float32 rtol/atol 1e-5 (the same float32 arithmetic summed in
other orders), gradients 1e-5; the FFN outputs 1e-4 of their largest
value (two float32 products of width 64).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)

TOL = 1e-5
EXTRAS = {"generator", "device", "dtype"}

FUNCTIONS = [
    (F.linear, JF.linear),
    (F.dropout, JF.dropout),
    (F.layer_norm, JF.layer_norm),
    (F.rms_norm, JF.rms_norm),
    (F.swiglu, JF.swiglu),
    (F.scaled_dot_product_attention, JF.scaled_dot_product_attention),
    (F.flashmask_attention, JF.flashmask_attention),
    (F.paged_attention, JF.paged_attention),
    (F.ragged_paged_attention, JF.ragged_paged_attention),
    (F.cross_entropy, JF.cross_entropy),
    (TIF.fused_bias_dropout_residual_layer_norm,
     JIF.fused_bias_dropout_residual_layer_norm),
    (TIF.fused_feedforward, JIF.fused_feedforward),
    (TIF.fused_rotary_position_embedding,
     JIF.fused_rotary_position_embedding),
    (F.gelu, JF.gelu),
    (F.relu, JF.relu),
    (F.tanh, JF.tanh),
] + [(getattr(TIF, n), getattr(JIF, n)) for n in (
    "fused_linear", "fused_bias_act", "fused_layer_norm",
    "fused_dropout_add", "fused_matmul_bias", "fused_linear_activation",
    "fused_multi_head_attention", "fused_multi_transformer",
    "block_multihead_attention", "masked_multihead_attention")]
LAYERS = [
    (tnn.Linear, jnn.Linear),
    (tnn.Embedding, jnn.Embedding),
    (tnn.RMSNorm, jnn.RMSNorm),
    (tnn.LayerNorm, jnn.LayerNorm),
] + [(getattr(tnn, n), getattr(jnn, n)) for n in (
    "Dropout", "Sequential", "LayerList", "MultiHeadAttention",
    "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer")] + [
    (getattr(tinn, n), getattr(jinn, n)) for n in (
        "FusedBiasDropoutResidualLayerNorm", "FusedLinear",
        "FusedDropoutAdd", "FusedMultiHeadAttention", "FusedFeedForward",
        "FusedTransformerEncoderLayer", "FusedMultiTransformer")] + [
    (getattr(tgpt, n), getattr(jgpt, n)) for n in (
        "GPTAttention", "GPTBlock", "GPTModel", "GPTForCausalLM")] + [
    (getattr(tbert, n), getattr(jbert, n)) for n in (
        "BertEmbeddings", "BertModel", "BertForMaskedLM",
        "BertForSequenceClassification")]
# a JAX activation layer takes its functional's parameters after x
# (``paddle_tpu/nn/layer/activation.py:_make``)
ACTIVATION_LAYERS = [(tnn.GELU, JF.gelu), (tnn.ReLU, JF.relu),
                     (tnn.Tanh, JF.tanh)]


def _params(fn):
    fn = inspect.unwrap(fn)
    return [p for p in inspect.signature(fn).parameters.values()
            if p.name != "self"]


def _same_surface(port, ref, skip=0):
    """port's parameters are ref's (after its first `skip`): names,
    defaults and kinds, then keyword-only EXTRAS."""
    want = [(p.name, p.default, p.kind) for p in _params(ref)[skip:]]
    got = _params(port)
    assert [(p.name, p.default, p.kind) for p in got[:len(want)]] == want
    extra = got[len(want):]
    assert all(p.kind == p.KEYWORD_ONLY and p.name in EXTRAS
               for p in extra), [p.name for p in extra]


@pytest.mark.parametrize("port,ref", FUNCTIONS,
                         ids=[f.__name__ for f, _ in FUNCTIONS])
def test_function_signature_matches_jax(port, ref):
    _same_surface(port, ref)


@pytest.mark.parametrize("port,ref", LAYERS,
                         ids=[c.__name__ for c, _ in LAYERS])
def test_layer_signature_matches_jax(port, ref):
    _same_surface(port.__init__, ref.__init__)


@pytest.mark.parametrize("port,ref", ACTIVATION_LAYERS,
                         ids=[c.__name__ for c, _ in ACTIVATION_LAYERS])
def test_activation_layer_signature_matches_jax(port, ref):
    _same_surface(port.__init__, ref, skip=1)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*map(paddle.to_tensor, arrays), **kw).numpy())


@pytest.mark.parametrize("axis", [-1, 1])
def test_rms_norm_bias_and_axis(axis):
    """A third positional argument is the bias, as in JAX; the norm runs
    over the dims from begin_norm_axis on; no weight multiplies by 1."""
    rng = np.random.default_rng(0)
    x = _f32(rng, (2, 3, 8))
    shape = x.shape[axis % 3:]
    w, b = _f32(rng, shape), _f32(rng, shape)
    got = F.rms_norm(*map(torch.from_numpy, (x, w, b)), 1e-5, axis)
    want = _jax(JF.rms_norm, x, w, b, epsilon=1e-5, begin_norm_axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    got = F.rms_norm(torch.from_numpy(x), begin_norm_axis=axis)
    want = _jax(JF.rms_norm, x, begin_norm_axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_swiglu_of_one_tensor_splits_it():
    rng = np.random.default_rng(1)
    x = _f32(rng, (4, 16))
    got = F.swiglu(torch.from_numpy(x))
    want = _jax(JF.swiglu, x)
    assert got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


CE_CASES = {
    "hard_weight": dict(weight=True),
    "hard_weight_sum": dict(weight=True, reduction="sum"),
    "hard_smooth_ignore": dict(label_smoothing=0.1, ignore=True),
    "hard_axis1": dict(axis=1),
    "soft": dict(soft=True),
    "soft_weight_smooth": dict(soft=True, weight=True, label_smoothing=0.2),
    "soft_weight_none": dict(soft=True, weight=True, reduction="none"),
    "probs": dict(use_softmax=False),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case):
    """A third positional argument is the class weight, as in JAX."""
    kw = dict(CE_CASES[case])
    rng = np.random.default_rng(2)
    n, c = 6, 5
    axis = kw.pop("axis", -1)
    logits = _f32(rng, (n, c) if axis == -1 else (n, c, 3))
    if kw.pop("use_softmax", True) is False:
        logits = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        kw["use_softmax"] = False
    if kw.pop("soft", False):
        label = rng.random(logits.shape).astype(np.float32)
        label /= label.sum(axis, keepdims=True)
        kw["soft_label"] = True
    else:
        shape = (n,) if axis == -1 else (n, 3)
        label = rng.integers(0, c, shape).astype(np.int64)
        if kw.pop("ignore", False):
            label[1] = -100
    weight = _f32(rng, (c,)) ** 2 + 0.5 if kw.pop("weight", False) else None
    args = [logits, label] + ([weight] if weight is not None else [])
    got = F.cross_entropy(*map(torch.from_numpy, args), axis=axis, **kw)
    want = _jax(JF.cross_entropy, *args, axis=axis, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_linear_has_a_zero_bias_by_default():
    rng = np.random.default_rng(3)
    lin = tnn.Linear(4, 8, device="cpu")
    assert lin.bias is not None and lin.bias.shape == (8,)
    assert not bool(lin.bias.detach().any())
    assert tnn.Linear(4, 8, bias_attr=False, device="cpu").bias is None
    ref = jnn.Linear(4, 8)
    w, b, x = _f32(rng, (4, 8)), _f32(rng, (8,)), _f32(rng, (3, 4))
    ref.weight.set_value(w)
    ref.bias.set_value(b)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               ref(paddle.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)
    with pytest.raises(TypeError, match="ParamAttr"):
        tnn.Linear(4, 8, bias_attr=object(), device="cpu")


def test_embedding_padding_idx():
    """The padding row starts at 0; positions holding padding_idx read
    their row and pass it no gradient, as JAX's F.embedding does."""
    rng = np.random.default_rng(4)
    emb = tnn.Embedding(6, 3, padding_idx=2, device="cpu")
    assert not bool(emb.weight[2].detach().any())
    w = _f32(rng, (6, 3))
    ids = np.array([[0, 2, 5], [2, 2, 1]], np.int64)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w))
    out = emb(torch.from_numpy(ids))
    want = _jax(JF.embedding, ids, w, padding_idx=2)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=0)
    out.sum().backward()
    grad = emb.weight.grad.numpy()
    assert np.all(grad[2] == 0)
    np.testing.assert_allclose(grad[[0, 1, 5]], np.ones((3, 3)))
    assert tnn.Embedding(6, 3, padding_idx=-1,
                         device="cpu").padding_idx == 5


@pytest.mark.parametrize("activation", ["silu", "sigmoid", "tanh", "elu",
                                        "leaky_relu", "softplus",
                                        "hard_swish"])
def test_fused_feedforward_takes_jax_nn_activations(activation):
    rng = np.random.default_rng(5)
    x = _f32(rng, (2, 4, 16))
    w1, w2 = 0.3 * _f32(rng, (16, 64)), 0.3 * _f32(rng, (64, 16))
    b1, b2 = _f32(rng, (64,)), _f32(rng, (16,))
    args = (x, w1, w2, b1, b2)
    got = TIF.fused_feedforward(*map(torch.from_numpy, args),
                                dropout1_rate=0.0, dropout2_rate=0.0,
                                activation=activation, pre_layer_norm=True)
    want = _jax(JIF.fused_feedforward, *args, dropout1_rate=0.0,
                dropout2_rate=0.0, activation=activation,
                pre_layer_norm=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
