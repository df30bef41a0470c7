"""Training GPT and BERT on the port against the JAX package, and
``incubate.nn.functional.fused_linear_param_grad_add``.

Every case starts both packages from the JAX model's weights (bridged by
name) and feeds them the same numpy-seeded batch. Tolerances, with their
reasons (as in ``test_torch_train.py``):

- float32 first loss: atol 1e-5; first gradients: 2e-5 absolute plus 1e-4
  relative (the same float32 products summed in other orders through 2
  layers, and the flash/XLA attention formulations);
- float32 losses over 5 ``compile_train_step`` steps of AdamW: atol 1e-4
  (AdamW's first steps are ~lr sign(g); near-zero gradients may flip sign
  between the two sides, which moves the loss far less than 1e-4);
- bfloat16 GPT with ``multi_precision``: each loss within two bfloat16
  ulps of JAX's at its size (the losses are bfloat16: the two sides'
  roundings over 5 steps), and falling;
- ``fused_linear_param_grad_add``: float32 within 1e-5 (one product of
  width 24 in another order), bfloat16 within 2^-7 of each output's
  largest value (one rounding of the product).

Dropout: with p > 0 the two packages draw different masks (their random
streams differ), so BERT with its configured dropout 0.1 is held to the
port itself: the loss falls over 8 steps, and a second run from the same
``seed`` gives the same losses.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu import jit as jjit
from paddle_tpu import models as jm
from paddle_tpu import optimizer as jopt

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch import models as tm

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


MODELS = {
    "gpt": (lambda: jm.GPTForCausalLM(jm.GPTConfig.tiny()),
            lambda: tm.GPTForCausalLM(tm.GPTConfig.tiny(), device="cpu")),
    "bert_mlm": (
        lambda: jm.BertForMaskedLM(_no_dropout(jm.BertConfig.tiny())),
        lambda: tm.BertForMaskedLM(_no_dropout(tm.BertConfig.tiny()),
                                   device="cpu")),
    "bert_cls": (
        lambda: jm.BertForSequenceClassification(
            _no_dropout(jm.BertConfig.tiny()), num_classes=3),
        lambda: tm.BertForSequenceClassification(
            _no_dropout(tm.BertConfig.tiny()), num_classes=3,
            device="cpu")),
}


def _pair(kind, dtype="float32"):
    paddle.seed(0)
    j = MODELS[kind][0]()
    if dtype == "bfloat16":
        j.bfloat16()
    t = MODELS[kind][1]()
    t = weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in j.named_parameters()},
        t.to(getattr(torch, dtype)))
    t.train()
    return j, t


def _batch(kind):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (4, 16))
    if kind == "bert_cls":
        return ids, rng.integers(0, 3, (4,))
    lab = ids.copy() if kind == "bert_mlm" else rng.integers(0, 128, (4, 16))
    if kind == "bert_mlm":
        lab[rng.random(lab.shape) >= 0.15] = -100
    return ids, lab


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_first_loss_and_grads_match_jax(kind):
    j, t = _pair(kind)
    ids, lab = _batch(kind)
    jl = j(paddle.to_tensor(ids), labels=paddle.to_tensor(lab))
    jl.backward()
    tl = t(torch.from_numpy(ids), labels=torch.from_numpy(lab))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=1e-5)
    jg = {n: p.grad for n, p in j.named_parameters()}
    for n, p in t.named_parameters():
        if jg[n] is None:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, n
            continue
        np.testing.assert_allclose(p.grad.numpy(), jg[n].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=n)


def _warmup_cosine(m):
    return m.lr.LinearWarmup(m.lr.CosineAnnealingDecay(3e-3, 10), 2, 0.0,
                             3e-3)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_train_steps_match_jax(kind):
    """5 steps of compile_train_step with AdamW under LinearWarmup(
    CosineAnnealingDecay), the scheduler stepped after each."""
    j, t = _pair(kind)
    ids, lab = _batch(kind)
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    jo = jopt.AdamW(_warmup_cosine(jopt), parameters=j.parameters())
    to = topt.AdamW(_warmup_cosine(topt), parameters=t.parameters())
    jstep = jjit.compile_train_step(j, loss_fn, jo)
    tstep = compile_train_step(t, loss_fn, to)
    jl, tl = [], []
    for _ in range(5):
        assert to.get_lr() == jo.get_lr()
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(lab))))
        tl.append(float(tstep(torch.from_numpy(ids), torch.from_numpy(lab))))
        jo._lr_scheduler.step()
        to._lr_scheduler.step()
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[-1] < tl[0]


def test_gpt_bfloat16_multi_precision_tracks_jax():
    j, t = _pair("gpt", "bfloat16")
    ids, lab = _batch("gpt")
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    jstep = jjit.compile_train_step(j, loss_fn, jopt.AdamW(
        3e-3, parameters=j.parameters(), multi_precision=True))
    to = topt.AdamW(3e-3, parameters=t.parameters(), multi_precision=True)
    tstep = compile_train_step(t, loss_fn, to)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(lab)))
          for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(lab)))
          for _ in range(5)]
    for got, want in zip(tl, jl):
        ulp = 2.0 ** (np.floor(np.log2(abs(want))) - 7)
        assert abs(got - want) <= 2 * ulp, (tl, jl)
    assert tl[-1] < tl[0]
    assert all(p.dtype == torch.bfloat16 for p in t.parameters())
    assert len(to._master_weights) == len(list(t.parameters()))


def test_bert_with_dropout_trains_and_replays_from_a_seed():
    def run():
        prandom.seed(5)
        t = tm.BertForMaskedLM(tm.BertConfig.tiny(), device="cpu")
        weights.from_paddle_tpu_state(weights.random_state(t, 0), t)
        t.train()
        ids, lab = _batch("bert_mlm")
        step = compile_train_step(t, lambda m, i, l: m(i, labels=l),
                                  topt.AdamW(3e-3, parameters=t.parameters()))
        return [float(step(torch.from_numpy(ids), torch.from_numpy(lab)))
                for _ in range(8)]

    a, b = run(), run()
    assert a == b
    assert a[-1] < a[0]
    assert tm.BertConfig.tiny().hidden_dropout_prob == 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("acc,has_bias", [(False, True), (True, True),
                                          (True, False)])
def test_fused_linear_param_grad_add_matches_jax(dtype, acc, has_bias):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    dout = rng.standard_normal((2, 12, 5)).astype(np.float32)
    dw0 = rng.standard_normal((8, 5)).astype(np.float32) if acc else None
    db0 = rng.standard_normal(5).astype(np.float32) \
        if acc and has_bias else None

    def jt(a):
        return None if a is None else jnp.asarray(a, jnp.dtype(dtype))

    def tt(a):
        return None if a is None else torch.from_numpy(a).to(
            getattr(torch, dtype))

    want = JIF.fused_linear_param_grad_add(
        paddle.to_tensor(jt(x)), paddle.to_tensor(jt(dout)),
        None if dw0 is None else paddle.to_tensor(jt(dw0)),
        None if db0 is None else paddle.to_tensor(jt(db0)),
        has_bias=has_bias)
    got = TIF.fused_linear_param_grad_add(tt(x), tt(dout), tt(dw0), tt(db0),
                                          has_bias=has_bias)
    want = want if has_bias else (want,)
    got = got if has_bias else (got,)
    assert len(got) == len(want) == (2 if has_bias else 1)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        wv = np.asarray(w._value.astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2 ** -7 * np.abs(wv).max()
        np.testing.assert_allclose(g.float().numpy(), wv, atol=tol)
