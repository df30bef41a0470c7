"""The port's ``incubate.nn`` layers and functionals against the JAX
package's.

Float32 on the CPU, parameters redrawn from a numpy seed in the JAX layer
and bridged into the port's with ``weights.from_paddle_tpu_state`` (the
names must match), eval mode unless a case says otherwise:

- the six fused layers: ``FusedLinear`` (both weight layouts),
  ``FusedDropoutAdd`` (eval in both modes; training keep rate),
  ``FusedMultiHeadAttention`` and ``FusedFeedForward`` post- and
  pre-norm, with and without a mask, ``FusedTransformerEncoderLayer`` and
  ``FusedMultiTransformer`` (``layer_{i}`` names); the post-norm tails go
  through the bdrln op once each, the pre-norm ones never, and attention
  without a mask through the flash op;
- the functionals: ``fused_linear``, ``fused_bias_act`` (jax.nn names,
  swiglu, geglu), ``fused_layer_norm``, ``fused_dropout_add``,
  ``fused_matmul_bias`` (transposes, no bias), ``fused_linear_activation``,
  ``fused_multi_head_attention`` (``transpose_qkv_wb``, no residual),
  ``fused_multi_transformer`` (pre- and post-norm), and
  ``block_multihead_attention`` and ``masked_multihead_attention``.

Tolerance: 1e-5 of each output's largest value (float32 summed in other
orders; the bdrln op's LayerNorm multiplies its weight before the one
cast, ``F.layer_norm`` after, equal in float32 to ~1e-7).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.incubate.nn.functional as JIF

from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

E, H, FFN = 32, 4, 64


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return paddle.to_tensor(a)


def _close(got, want, rel=1e-5):
    want = np.asarray(getattr(want, "_value", want), np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _bridge(jl, tl, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {}
    for n, p in jl.named_parameters():
        a = (0.3 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        p.set_value(a)
        arrays[n] = a
    weights.from_paddle_tpu_state(arrays, tl)
    jl.eval()
    tl.eval()
    return jl, tl


@pytest.fixture
def spies(monkeypatch):
    """Calls of the flash and bdrln ops during a test."""
    calls = {"flash": 0, "bdrln": 0}
    for key, fn in (("flash", K.FlashAttention),
                    ("bdrln", K.BiasDropoutResidualLN)):
        orig = fn.apply

        def spy(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)
        monkeypatch.setattr(fn, "apply", spy)
    return calls


def _mask(b, s):
    keep = np.ones((b, 1, s, s), bool)
    keep[0, :, :, s - 2:] = False
    return keep


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_layer_and_functional(transpose):
    paddle.seed(0)
    jl, tl = _bridge(jinn.FusedLinear(E, 16, transpose_weight=transpose),
                     tinn.FusedLinear(E, 16, transpose_weight=transpose,
                                      device="cpu"))
    x = _x(3, E)
    _close(tl(torch.from_numpy(x)), jl(_t(x)))
    w, b = _x(16, E, seed=2), _x(16, seed=3)
    _close(TIF.fused_linear(*map(torch.from_numpy, (x, w, b)), True),
           JIF.fused_linear(*map(_t, (x, w, b)), transpose_weight=True))
    assert tinn.FusedLinear(E, 16, bias_attr=False,
                            device="cpu").bias is None


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_fused_dropout_add(mode):
    x, y = _x(200, 1000), _x(200, 1000, seed=2)
    tl = tinn.FusedDropoutAdd(0.25, mode=mode).eval()
    jl = jinn.FusedDropoutAdd(0.25, mode=mode)
    jl.eval()
    _close(tl(torch.from_numpy(x), torch.from_numpy(y)), jl(_t(x), _t(y)))
    _close(TIF.fused_dropout_add(torch.from_numpy(x), torch.from_numpy(y),
                                 0.25, training=False, mode=mode),
           JIF.fused_dropout_add(_t(x), _t(y), 0.25, training=False,
                                 mode=mode))
    out = tl.train()(torch.from_numpy(x), torch.from_numpy(y)).numpy() - y
    kept = np.abs(out) > 1e-6
    assert abs(kept.mean() - 0.75) < 0.005


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
def test_fused_multi_head_attention_layer(pre, masked, spies):
    paddle.seed(0)
    jl, tl = _bridge(jinn.FusedMultiHeadAttention(E, H,
                                                  normalize_before=pre),
                     tinn.FusedMultiHeadAttention(E, H, normalize_before=pre,
                                                  device="cpu"))
    x = _x(2, 6, E)
    m = _mask(2, 6) if masked else None
    want = jl(_t(x), attn_mask=None if m is None else _t(m))
    got = tl(torch.from_numpy(x),
             attn_mask=None if m is None else torch.from_numpy(m))
    _close(got, want)
    assert spies == {"flash": 0 if masked else 1, "bdrln": 0 if pre else 1}


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
def test_fused_feed_forward_layer(pre, act, spies):
    paddle.seed(0)
    jl, tl = _bridge(jinn.FusedFeedForward(E, FFN, activation=act,
                                           normalize_before=pre),
                     tinn.FusedFeedForward(E, FFN, activation=act,
                                           normalize_before=pre,
                                           device="cpu"))
    x = _x(2, 6, E)
    _close(tl(torch.from_numpy(x)), jl(_t(x)))
    assert spies["bdrln"] == (0 if pre else 1)


@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
def test_fused_encoder_layer_and_multi_transformer(pre, spies):
    paddle.seed(0)
    jl, tl = _bridge(
        jinn.FusedTransformerEncoderLayer(E, H, FFN, activation="gelu",
                                          normalize_before=pre),
        tinn.FusedTransformerEncoderLayer(E, H, FFN, activation="gelu",
                                          normalize_before=pre,
                                          device="cpu"))
    x, m = _x(2, 6, E), _mask(2, 6)
    _close(tl(torch.from_numpy(x)), jl(_t(x)))
    _close(tl(torch.from_numpy(x), torch.from_numpy(m)), jl(_t(x), _t(m)))
    assert spies["bdrln"] == (0 if pre else 4)
    jm, tm = _bridge(
        jinn.FusedMultiTransformer(E, H, FFN, normalize_before=pre,
                                   num_layers=3),
        tinn.FusedMultiTransformer(E, H, FFN, normalize_before=pre,
                                   num_layers=3, device="cpu"), seed=1)
    assert "layer_2.ffn.linear2_weight" in dict(tm.named_parameters())
    assert tinn.FusedMultiTransformer(E, H, FFN, qkv_weight_attrs=[None] * 2,
                                      device="cpu").num_layers == 2
    _close(tm(torch.from_numpy(x)), jm(_t(x)))
    _close(tm(torch.from_numpy(x), torch.from_numpy(m)), jm(_t(x), _t(m)))


def test_fused_bias_act_and_layer_norm():
    x, b = _x(4, 16), _x(16, seed=2)
    for act in ("gelu", "relu", "silu", "sigmoid", "swiglu", "geglu"):
        _close(TIF.fused_bias_act(torch.from_numpy(x), torch.from_numpy(b),
                                  act_method=act),
               JIF.fused_bias_act(_t(x), _t(b), act_method=act))
    w = _x(16, seed=3)
    _close(TIF.fused_layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6),
           JIF.fused_layer_norm(*map(_t, (x, w, b)), 1e-6))


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True)])
def test_fused_matmul_bias_and_linear_activation(tx, ty):
    a = _x(5, 8) if tx else _x(8, 5)
    c = _x(6, 5, seed=2) if ty else _x(5, 6, seed=2)
    b = _x(6, seed=3)
    _close(TIF.fused_matmul_bias(*map(torch.from_numpy, (a, c, b)), tx, ty),
           JIF.fused_matmul_bias(*map(_t, (a, c, b)), tx, ty))
    _close(TIF.fused_matmul_bias(torch.from_numpy(a), torch.from_numpy(c),
                                 None, tx, ty),
           JIF.fused_matmul_bias(_t(a), _t(c), None, tx, ty))
    for act in ("relu", "none", None):
        _close(TIF.fused_linear_activation(
            *map(torch.from_numpy, (a, c, b)), tx, ty, act),
            JIF.fused_linear_activation(*map(_t, (a, c, b)), tx, ty, act))


@pytest.mark.parametrize("case", ["pre", "post", "transposed", "no_residual"])
def test_fused_multi_head_attention_functional(case):
    rng = np.random.default_rng(5)
    x = _x(2, 6, E)
    qkv = (0.3 * rng.standard_normal((3, H, E // H, E))).astype(np.float32)
    if case == "transposed":
        qkv = qkv.reshape(E, 3 * E)
    arrays = dict(
        qkv_weight=qkv,
        linear_weight=(0.3 * rng.standard_normal((E, E))).astype(np.float32),
        pre_ln_scale=_x(E, seed=6), pre_ln_bias=_x(E, seed=7),
        ln_scale=_x(E, seed=8), ln_bias=_x(E, seed=9),
        qkv_bias=_x(3, H, E // H, seed=10), linear_bias=_x(E, seed=11))
    kw = dict(pre_layer_norm=case == "pre", training=False,
              add_residual=case != "no_residual")
    if case == "transposed":
        kw.update(transpose_qkv_wb=True, num_heads=H)
    _close(TIF.fused_multi_head_attention(
        torch.from_numpy(x), **{k: torch.from_numpy(v)
                                for k, v in arrays.items()}, **kw),
        JIF.fused_multi_head_attention(
            _t(x), **{k: _t(v) for k, v in arrays.items()}, **kw))


@pytest.mark.parametrize("pre", [True, False])
def test_fused_multi_transformer_functional(pre):
    rng = np.random.default_rng(6)

    def draw(*shape):
        return [(0.3 * rng.standard_normal(shape)).astype(np.float32)
                for _ in range(2)]
    args = [draw(E), draw(E), draw(3, H, E // H, E), draw(3, H, E // H),
            draw(E, E), draw(E), draw(E), draw(E), draw(E, FFN), draw(FFN),
            draw(FFN, E), draw(E)]
    x = _x(2, 6, E)
    _close(TIF.fused_multi_transformer(
        torch.from_numpy(x), *[[torch.from_numpy(a) for a in ls]
                               for ls in args], pre_layer_norm=pre),
        JIF.fused_multi_transformer(
            _t(x), *[[_t(a) for a in ls] for ls in args],
            pre_layer_norm=pre))


def test_block_and_masked_multihead_attention():
    b, h, hkv, d = 2, 4, 2, 16
    x = _x(b, 1, h, d)
    ck, cv = _x(b, 8, hkv, d, seed=2), _x(b, 8, hkv, d, seed=3)
    _close(TIF.masked_multihead_attention(
        *map(torch.from_numpy, (x, ck, cv)), seq_len=5),
        JIF.masked_multihead_attention(*map(_t, (x, ck, cv)), seq_len=5))
    kp, vp = _x(8, 4, hkv, d, seed=4), _x(8, 4, hkv, d, seed=5)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    ctx = np.array([7, 5], np.int32)
    for q in (x[:, 0], x):
        _close(TIF.block_multihead_attention(
            *map(torch.from_numpy, (q, kp, vp, bt, ctx))),
            JIF.block_multihead_attention(*map(_t, (q, kp, vp, bt, ctx))))
    with pytest.raises(ValueError, match="ONE query"):
        TIF.block_multihead_attention(torch.zeros(2, 3, h, d),
                                      *map(torch.from_numpy,
                                           (kp, vp, bt, ctx)))
