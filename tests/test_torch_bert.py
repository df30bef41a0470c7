"""The port's BERT against the JAX package's.

Tiny BERTs (``BertConfig.tiny()``: 2 layers, hidden 64, 4 heads of 16)
made by the JAX package from seed 0, their weights bridged with
``paddle_tpu_torch.weights``, float32 on the CPU, in eval mode:

- ``BertModel`` (sequence output and pooled), ``BertForMaskedLM``
  (logits, and the loss with labels of -100 ignored) and
  ``BertForSequenceClassification`` (logits and loss), each with token
  types, with and without an ``attention_mask`` (the padding changes the
  real rows' outputs); attention routes as in JAX: without a mask
  through the flash op (``FlashAttention``, once a layer), with one
  through the dense path (the flash op not called);
- every JAX parameter name loads through ``weights.from_paddle_tpu_state``;
  the random init gives every LayerNorm weight 1 and every bias 0.

Tolerance: 1e-4 of each output's largest value (the same float32
arithmetic summed in other orders).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

HEADS = ("BertModel", "BertForMaskedLM", "BertForSequenceClassification")


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, name in enumerate(HEADS):
        paddle.seed(i)
        jm = getattr(jbert, name)(jbert.BertConfig.tiny())
        jm.eval()
        arrays = {n: np.asarray(p._value, np.float32)
                  for n, p in jm.named_parameters()}
        tm = getattr(tbert, name)(tbert.BertConfig.tiny(), device="cpu")
        tm.eval()
        weights.from_paddle_tpu_state(arrays, tm)
        out[name] = (jm, tm)
    return out


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (3, 16))
    types = rng.integers(0, 2, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    return ids, types, mask


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _outputs(model, jax, ids, types, mask, labels):
    if jax:
        t = paddle.to_tensor
        out = model(t(ids), t(types), None if mask is None else t(mask),
                    **({} if labels is None else {"labels": t(labels)}))
        return [np.asarray(o._value) for o in
                (out if isinstance(out, tuple) else (out,))]
    t = torch.from_numpy
    with torch.no_grad():
        out = model(t(ids), t(types), None if mask is None else t(mask),
                    **({} if labels is None else {"labels": t(labels)}))
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("head", HEADS)
def test_bert_heads_match_jax(models, head, masked, monkeypatch):
    jm, tm = models[head]
    ids, types, mask = _inputs()
    mask = mask if masked else None
    want = _outputs(jm, True, ids, types, mask, None)
    calls = []
    flash = K.FlashAttention.apply
    monkeypatch.setattr(K.FlashAttention, "apply",
                        lambda *a: calls.append(a[3]) or flash(*a))
    got = _outputs(tm, False, ids, types, mask, None)
    assert calls == ([] if masked else [False, False])   # non-causal
    monkeypatch.undo()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    if head != "BertModel":
        losses = []
        labels = np.random.default_rng(1).integers(
            0, 128 if head == "BertForMaskedLM" else 2,
            (3, 16) if head == "BertForMaskedLM" else (3,))
        if head == "BertForMaskedLM":
            labels[:, ::3] = -100            # ignored positions
        for jax, m in ((True, jm), (False, tm)):
            losses.append(_outputs(m, jax, ids, types, mask, labels)[0])
        _close(losses[1], losses[0])
    if masked:       # padding changes what the real positions see
        free = _outputs(tm, False, ids, types, None, None)[0]
        assert not torch.allclose(free[1, :9], got[0][1, :9])


def test_every_jax_parameter_loads_and_init_rule(models):
    jm, tm = models["BertForMaskedLM"]
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(p.shape) for n, p in jm.named_parameters()}
    state = weights.random_state(tm, seed=0)
    norms = [n for n in state if "norm" in n and n.endswith("weight")] + \
        ["transform.2.weight"]
    assert "bert.embeddings.layer_norm.weight" in norms
    assert "bert.encoder.layers.1.norm2.weight" in norms
    for n in norms:
        assert np.all(state[n] == 1), n
    for n in state:
        if n.endswith("bias"):
            assert np.all(state[n] == 0), n
    assert 0.015 < state["bert.encoder.layers.0.linear1.weight"].std() < 0.025
