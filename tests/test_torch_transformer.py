"""The port's transformer layers, containers, dropout and activations
against the JAX package's.

Each JAX layer is made from seed 0, its parameters redrawn from a numpy
seed (so that norm weights and biases are not ones and zeros) and bridged
into the port's layer with ``weights.from_paddle_tpu_state`` (so the names
match JAX's), float32 on the CPU, in eval mode:

- ``MultiHeadAttention`` without a mask (the flash op), with a bool and
  an additive mask (the dense path), with other key/value widths, and
  step by step through a ``Cache`` and over a ``StaticCache``;
- ``TransformerEncoderLayer``/``TransformerEncoder`` post- and pre-norm,
  with a mask and through caches; ``TransformerDecoderLayer``/
  ``TransformerDecoder`` with a causal target mask, a memory mask and
  step by step through ``gen_cache``; ``Transformer`` with
  ``generate_square_subsequent_mask``; a stack's clones have parameters of
  their own;
- ``Sequential`` (names "0", "1", ..., the (name, layer) list form,
  slicing) and ``LayerList``; ``Dropout`` (eval: identity, or 1 - p in
  "downscale_in_infer"; training: the keep rate within 0.005 of 1 - p over
  200,000 draws, kept values scaled by 1 / (1 - p), one draw shared along
  ``axis``);
- the two GELUs: the exact one (``F.gelu``, ``nn.GELU``, the encoder
  layers' ``activation="gelu"``) and the tanh one (``fused_bias_act`` and
  ``fused_linear_activation``), each equal to its JAX counterpart and the
  two unequal.

Tolerance: 1e-5 of each output's largest value (float32 summed in other
orders); the GELUs 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

E, H, FFN = 32, 4, 64


def _bridge(jl, tl, seed=0):
    """Redraw jl's parameters from `seed` and load them into tl; both in
    eval mode."""
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


def _masks(kind, b, s, t):
    if kind == "none":
        return None, None
    keep = np.ones((b, 1, s, t), bool)
    keep[1, :, :, t - 3:] = False
    if kind == "bool":
        return _t(keep), torch.from_numpy(keep)
    add = np.where(keep, 0.0, -1e4).astype(np.float32)
    return _t(add), torch.from_numpy(add)


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_multi_head_attention_matches_jax(mask, monkeypatch):
    paddle.seed(0)
    jl, tl = _bridge(jnn.MultiHeadAttention(E, H),
                     tnn.MultiHeadAttention(E, H, device="cpu"))
    q, kv = _x(2, 5, E), _x(2, 7, E, seed=2)
    jm, tm = _masks(mask, 2, 5, 7)
    calls = []
    flash = K.FlashAttention.apply
    monkeypatch.setattr(K.FlashAttention, "apply",
                        lambda *a: calls.append(a) or flash(*a))
    got = tl(torch.from_numpy(q), torch.from_numpy(kv),
             torch.from_numpy(kv), tm)
    assert len(calls) == (1 if mask == "none" else 0)
    _close(got, jl(_t(q), _t(kv), _t(kv), jm))


def test_multi_head_attention_other_key_widths():
    paddle.seed(0)
    jl, tl = _bridge(jnn.MultiHeadAttention(E, H, kdim=24, vdim=40),
                     tnn.MultiHeadAttention(E, H, kdim=24, vdim=40,
                                            device="cpu"))
    q, k, v = _x(2, 5, E), _x(2, 6, 24, seed=2), _x(2, 6, 40, seed=3)
    _close(tl(*map(torch.from_numpy, (q, k, v))), jl(*map(_t, (q, k, v))))


def test_multi_head_attention_caches_match_jax():
    """Three steps through a Cache (the keys grow 0 -> 2 -> 3 -> 5) and a
    query over a StaticCache of projected memory."""
    paddle.seed(0)
    jl, tl = _bridge(jnn.MultiHeadAttention(E, H),
                     tnn.MultiHeadAttention(E, H, device="cpu"))
    x = _x(2, 5, E)
    jc, tc = jl.gen_cache(_t(x)), tl.gen_cache(torch.from_numpy(x))
    assert tuple(tc.k.shape) == (2, 0, H, E // H)
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        jo, jc = jl(_t(x[:, lo:hi]), cache=jc)
        to, tc = tl(torch.from_numpy(x[:, lo:hi]), cache=tc)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    mem = _x(2, 9, E, seed=4)
    js = jl.gen_cache(_t(mem), _t(mem), jnn.MultiHeadAttention.StaticCache)
    ts = tl.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                      tnn.MultiHeadAttention.StaticCache)
    assert isinstance(ts, tnn.MultiHeadAttention.StaticCache)
    _close(tl(torch.from_numpy(x), cache=ts), jl(_t(x), cache=js))


@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
def test_encoder_matches_jax(pre):
    paddle.seed(0)
    kw = dict(dropout=0.0, activation="gelu", normalize_before=pre)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(E, H, FFN,
                                                              **kw), 2,
                                  jnn.LayerNorm(E) if pre else None)
    tenc = tnn.TransformerEncoder(
        tnn.TransformerEncoderLayer(E, H, FFN, **kw, device="cpu"), 2,
        tnn.LayerNorm(E, device="cpu") if pre else None)
    jenc, tenc = _bridge(jenc, tenc)
    assert tenc.layers[0].activation is F.gelu          # exact GELU
    p0 = tenc.layers[0].linear1.weight
    assert p0 is not tenc.layers[1].linear1.weight      # clones: own params
    src = _x(2, 6, E)
    jm, tm = _masks("additive", 2, 6, 6)
    _close(tenc(torch.from_numpy(src)), jenc(_t(src)))
    _close(tenc(torch.from_numpy(src), tm), jenc(_t(src), jm))
    jc, tc = jenc.gen_cache(_t(src)), tenc.gen_cache(torch.from_numpy(src))
    jo, jc = jenc(_t(src), None, jc)
    to, tc = tenc(torch.from_numpy(src), None, tc)
    _close(to, jo)
    for a, b in zip(tc, jc):
        _close(a.k, b.k)


def test_decoder_matches_jax_whole_and_step_by_step():
    paddle.seed(0)
    kw = dict(dropout=0.0)
    jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(E, H, FFN,
                                                              **kw), 2)
    tdec = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(E, H, FFN, **kw, device="cpu"), 2)
    jdec, tdec = _bridge(jdec, tdec)
    tgt, mem = _x(2, 4, E), _x(2, 7, E, seed=2)
    causal = np.triu(np.full((4, 4), -1e4, np.float32), 1)
    jmm, tmm = _masks("bool", 2, 4, 7)
    _close(tdec(torch.from_numpy(tgt), torch.from_numpy(mem),
                torch.from_numpy(causal), tmm),
           jdec(_t(tgt), _t(mem), _t(causal), jmm))
    jc = jdec.gen_cache(_t(mem))
    tc = tdec.gen_cache(torch.from_numpy(mem))
    assert len(tdec.gen_cache(torch.from_numpy(mem), do_zip=True)) == 2
    for i in range(4):
        jo, jc = jdec(_t(tgt[:, i:i + 1]), _t(mem), None, None, jc)
        to, tc = tdec(torch.from_numpy(tgt[:, i:i + 1]),
                      torch.from_numpy(mem), None, None, tc)
        _close(to, jo)


@pytest.mark.parametrize("pre", [False, True], ids=["post_norm", "pre_norm"])
def test_transformer_matches_jax(pre):
    paddle.seed(0)
    kw = dict(d_model=E, nhead=H, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0,
              normalize_before=pre)
    jm, tm = _bridge(jnn.Transformer(**kw),
                     tnn.Transformer(**kw, device="cpu"))
    jmask = jm.generate_square_subsequent_mask(5)
    tmask = tm.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask._value))
    src, tgt = _x(2, 6, E), _x(2, 5, E, seed=2)
    _close(tm(torch.from_numpy(src), torch.from_numpy(tgt), None, tmask),
           jm(_t(src), _t(tgt), None, jmask))


def test_sequential_and_layer_list():
    paddle.seed(0)
    jseq = jnn.Sequential(jnn.Linear(E, FFN), jnn.GELU(), jnn.Linear(FFN, E))
    tseq = tnn.Sequential(tnn.Linear(E, FFN, device="cpu"), tnn.GELU(),
                          tnn.Linear(FFN, E, device="cpu"))
    jseq, tseq = _bridge(jseq, tseq)
    assert [n for n, _ in tseq.named_parameters()] == \
        ["0.weight", "0.bias", "2.weight", "2.bias"]
    x = _x(3, E)
    _close(tseq(torch.from_numpy(x)), jseq(_t(x)))
    assert isinstance(tseq[:2], tnn.Sequential) and len(tseq[:2]) == 2
    named = tnn.Sequential([("fc", tnn.Linear(E, E, device="cpu")),
                            ("act", tnn.ReLU())])
    assert [n for n, _ in named.named_children()] == ["fc", "act"]
    lst = tnn.LayerList([tnn.Tanh()])
    lst.append(tnn.ReLU())
    lst.insert(0, tnn.GELU())
    assert [type(m).__name__ for m in lst] == ["GELU", "Tanh", "ReLU"]
    assert len(lst) == 3 and isinstance(lst[1:], tnn.LayerList)
    assert [n for n, _ in lst.named_children()] == ["0", "1", "2"]
    y = _x(4, 6)
    for tm_, jm_ in ((tnn.ReLU(), jnn.ReLU()), (tnn.Tanh(), jnn.Tanh())):
        _close(tm_(torch.from_numpy(y)), jm_(_t(y)), 1e-6)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_eval_and_keep_rate(mode):
    x = _x(200, 1000)
    d = tnn.Dropout(0.25, mode=mode).eval()
    want = jnn.Dropout(0.25, mode=mode)
    want.eval()
    _close(d(torch.from_numpy(x)), want(_t(x)), 1e-6)
    d.train()
    out = d(torch.from_numpy(x)).numpy()
    kept = out != 0
    assert abs(kept.mean() - 0.75) < 0.005
    scale = 1 / 0.75 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[kept], x[kept] * scale, rtol=1e-6)
    rows = tnn.Dropout(0.5, axis=0).train()(torch.from_numpy(x)).numpy()
    assert set(np.unique((rows != 0).sum(1))) <= {0, 1000}


def test_the_two_gelus():
    x = np.linspace(-4, 4, 1001, dtype=np.float32)[None]
    exact_j = np.asarray(JF.gelu(_t(x))._value)
    for got in (F.gelu(torch.from_numpy(x)),
                tnn.GELU()(torch.from_numpy(x))):
        _close(got, exact_j, 1e-6)
    tanh_j = np.asarray(JIF.fused_bias_act(_t(x), act_method="gelu")._value)
    _close(TIF.fused_bias_act(torch.from_numpy(x), act_method="gelu"),
           tanh_j, 1e-6)
    _close(F.gelu(torch.from_numpy(x), approximate=True), tanh_j, 1e-6)
    w, b = _x(1, 1), _x(1, seed=2)
    _close(TIF.fused_linear_activation(torch.from_numpy(x.T),
                                       torch.from_numpy(w),
                                       torch.from_numpy(b)),
           JIF.fused_linear_activation(_t(x.T), _t(w), _t(b)), 1e-6)
    assert np.abs(exact_j - tanh_j).max() > 1e-4      # two functions
