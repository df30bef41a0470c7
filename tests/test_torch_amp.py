"""The port's mixed precision (``paddle_tpu_torch.amp``) against the JAX
package's (``paddle_tpu.amp``).

- The dtype table: under ``auto_cast`` O1 (float32 parameters) and O2
  (after ``decorate(O2, bfloat16)``), the type of every sublayer's output
  in a forward with labels of a tiny BERT (masked LM), GPT and Llama must
  equal the JAX model's, name for name, in call order (forward hooks on
  both sides), and so must the loss's.
- The cast rules: custom white and black lists, ``enable=False``, nesting,
  and a float32 parameter's gradient coming back float32 through an O1
  cast.
- ``decorate``: LayerNorm parameters stay float32, ``excluded_layers`` by
  type and by instance, masters on unless ``master_weight=False``.
- ``GradScaler``: a sequence of steps with an injected inf beside the JAX
  scaler (scale, skips, ``last_found_inf``, the parameters after each
  step, state_dict), and ``minimize``.
- ``tests/test_gpt_bert.py:46``'s pattern (BERT MLM, AdamW(3e-3),
  ``decorate(O2)``, ``GradScaler(1024)``, 8 steps) with dropout 0 and the
  JAX weights: the first loss within one bf16 ulp (0.125 at 16-32); the
  first backward's gradients each within 5% of its tensor's largest plus
  0.1% of the model's largest (bf16 products and roundings through two
  layers, ~2^-7 each; the second term covers the k biases, whose exact
  gradient is 0 and whose values are rounding noise on both sides); each
  step's loss within 5% or 0.0625 of JAX's (bfloat16 losses, spacing
  0.03125 at 4-8; AdamW's first steps move each parameter by ~lr sign(g),
  and the ~0.5% of gradient elements near 0 whose sign the two sides'
  roundings decide apart move the loss by ~2% a step), the loss falls,
  parameters stay bfloat16 with float32 masters and LayerNorm float32.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import models as jm
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JaxParameter

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import models as tm
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import weights
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)

MAKERS = {
    "bert": (lambda: jm.BertForMaskedLM(_no_dropout(jm.BertConfig.tiny())),
             lambda: tm.BertForMaskedLM(_no_dropout(tm.BertConfig.tiny()),
                                        device="cpu")),
    "gpt": (lambda: jm.GPTForCausalLM(jm.GPTConfig.tiny()),
            lambda: tm.GPTForCausalLM(tm.GPTConfig.tiny(), device="cpu")),
    "llama": (lambda: jm.LlamaForCausalLM(jm.LlamaConfig.tiny()),
              lambda: tm.LlamaForCausalLM(tm.LlamaConfig.tiny(),
                                          device="cpu")),
}


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _pair(kind):
    paddle.seed(0)
    j = MAKERS[kind][0]()
    t = weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in j.named_parameters()},
        MAKERS[kind][1]())
    t.train()
    return j, t


def _ids():
    return (np.arange(16).reshape(2, 8) * 7 % 100).astype(np.int64)


def _jax_table(model, level):
    rows = []
    for name, sub in model.named_sublayers(include_self=True):
        def hook(layer, inp, out, name=name):
            o = out[0] if isinstance(out, (tuple, list)) else out
            rows.append((name, str(o.dtype).replace("paddle.", "")))
        sub.register_forward_post_hook(hook)
    ids = paddle.to_tensor(_ids())
    with jamp.auto_cast(level=level):
        loss = model(ids, labels=ids)
    return rows, str(loss.dtype).replace("paddle.", "")


def _port_table(model, level):
    rows = []
    for name, sub in model.named_modules():
        def hook(mod, inp, out, name=name):
            o = out[0] if isinstance(out, (tuple, list)) else out
            rows.append((name, str(o.dtype).replace("torch.", "")))
        sub.register_forward_hook(hook)
    ids = torch.from_numpy(_ids())
    with tamp.auto_cast(level=level):
        loss = model(ids, labels=ids)
    return rows, str(loss.dtype).replace("torch.", "")


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_dtype_table_equals_jax(kind, level):
    j, t = _pair(kind)
    if level == "O2":
        jamp.decorate(j, jopt.AdamW(1e-3, parameters=j.parameters()),
                      level="O2", dtype="bfloat16")
        tamp.decorate(t, topt.AdamW(1e-3, parameters=t.parameters()),
                      level="O2", dtype="bfloat16")
        assert [str(p.dtype).replace("torch.", "")
                for p in t.parameters()] == \
            [str(p.dtype).replace("paddle.", "") for p in j.parameters()]
    want, want_loss = _jax_table(j, level)
    got, got_loss = _port_table(t, level)
    assert got == want
    assert got_loss == want_loss
    if level == "O1":
        assert len({d for _, d in got}) == 2      # both types appear


def test_cast_rules():
    x = torch.randn(2, 4)
    w = torch.nn.Parameter(torch.randn(4, 3))
    assert tamp.amp_cast("gelu", x) is x                 # O0: as given
    with tamp.auto_cast(level="O1"):
        assert tamp.amp_cast("linear", x).dtype == torch.bfloat16
        assert tamp.amp_cast("gelu", x).dtype == torch.float32
        ints = torch.arange(3)
        assert tamp.amp_cast("linear", ints) is ints      # not float32
        with tamp.auto_cast(level="O2", dtype="float16"):
            assert tamp.amp_cast("gelu", x).dtype == torch.float16
            assert tamp.amp_cast("softmax", x).dtype == torch.float32
        assert tamp.amp_cast("gelu", x).dtype == torch.float32
        y = F.linear(x, w)
        assert y.dtype == torch.bfloat16
        y.float().sum().backward()
        assert w.grad.dtype == torch.float32
    with tamp.auto_cast(level="O1", custom_white_list={"gelu"},
                        custom_black_list={"linear"}):
        assert tamp.amp_cast("gelu", x).dtype == torch.bfloat16
        assert tamp.amp_cast("linear", x).dtype == torch.float32
    with tamp.auto_cast(enable=False, level="O2"):
        assert tamp.amp_cast("gelu", x) is x
    with pytest.raises(ValueError, match="O0/O1/O2"):
        tamp.auto_cast(level="O3")
    assert tamp.amp_guard is tamp.auto_cast
    assert tamp.white_list() == jamp.white_list()
    assert tamp.black_list() == jamp.black_list()
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()


def test_decorate_keeps_norms_and_exclusions():
    cfg = _no_dropout(tm.BertConfig.tiny())
    model = tm.BertForMaskedLM(cfg, device="cpu")
    o = topt.AdamW(1e-3, parameters=model.parameters())
    enc0 = model.bert.encoder.layers[0]
    out = tamp.decorate(model, o, level="O2", dtype="bfloat16",
                        excluded_layers=[tnn.Embedding, enc0.linear1])
    assert out == (model, o) and o._multi_precision
    for name, mod in model.named_modules():
        for p in mod.parameters(recurse=False):
            want = torch.float32 if isinstance(
                mod, (tnn.LayerNorm, tnn.Embedding)) or mod is enc0.linear1 \
                else torch.bfloat16
            assert p.dtype == want, name
    lin = tnn.Linear(4, 4, device="cpu")
    o2 = topt.SGD(0.1, parameters=lin.parameters())
    tamp.decorate(lin, o2, level="O2", master_weight=False)
    assert lin.weight.dtype == torch.bfloat16 and not o2._multi_precision
    lin3 = tnn.Linear(4, 4, device="cpu")
    assert tamp.decorate(lin3, level="O1") is lin3
    assert lin3.weight.dtype == torch.float32


def test_grad_scaler_sequence_equals_jax():
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (3,)]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jps = [JaxParameter(jnp.asarray(a)) for a in arrays]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    jo = jopt.AdamW(0.01, parameters=jps)
    to = topt.AdamW(0.01, parameters=tps)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    for step in range(7):
        for jp, tp, s in zip(jps, tps, shapes):
            g = rng.standard_normal(s).astype(np.float32) * js._scale
            if step in (2, 5):
                g.flat[1] = np.inf if step == 2 else np.nan
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        js.step(jo)
        ts.step(to)
        assert ts.last_found_inf == js.last_found_inf == (step in (2, 5))
        js.update()
        ts.update()
        jo.clear_grad()
        to.clear_grad()
        assert ts._scale == js._scale
        assert ts.skipped_steps == js.skipped_steps
        assert ts.last_found_inf == js.last_found_inf
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                       rtol=1e-6, atol=1e-9)
    assert ts.skipped_steps == 2
    assert ts.state_dict() == js.state_dict()
    fresh = tamp.GradScaler()
    fresh.set_state_dict(ts.state_dict())
    assert fresh._scale == ts._scale
    assert float(ts.get_loss_scaling()) == ts._scale
    # minimize: the caller ran backward on the scaled loss
    loss = (tps[0] ** 2).sum()
    ts.scale(loss).backward()
    before = tps[0].detach().clone()
    ts.minimize(to, None)
    assert not torch.equal(before, tps[0])
    off = tamp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()


def test_bert_mlm_amp_o2_trains_as_jax():
    """tests/test_gpt_bert.py:46 with dropout 0, both sides from the JAX
    weights and the same masked labels."""
    j, t = _pair("bert")
    jo = jopt.AdamW(3e-3, parameters=j.parameters())
    to = topt.AdamW(3e-3, parameters=t.parameters())
    j, jo = jamp.decorate(j, jo, level="O2", dtype="bfloat16")
    t, to = tamp.decorate(t, to, level="O2", dtype="bfloat16")
    js = jamp.GradScaler(init_loss_scaling=1024.0)
    ts = tamp.GradScaler(init_loss_scaling=1024.0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (4, 16))
    labels = ids.copy()
    labels[rng.random(labels.shape) >= 0.15] = -100
    jl, tl = [], []
    for step in range(8):
        with jamp.auto_cast(level="O2"):
            loss = j(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        js.scale(loss).backward()
        if step == 0:
            jg = {n: np.asarray(p.grad._value.astype("float32"))
                  for n, p in j.named_parameters() if p.grad is not None}
        js.step(jo)
        js.update()
        jo.clear_grad()
        jl.append(float(loss.astype("float32").numpy()))
        with tamp.auto_cast(level="O2"):
            loss = t(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        ts.scale(loss).backward()
        if step == 0:
            tg = {n: p.grad.float().numpy().copy()
                  for n, p in t.named_parameters() if p.grad is not None}
        ts.step(to)
        ts.update()
        to.clear_grad()
        tl.append(loss.item())
    assert abs(tl[0] - jl[0]) <= 0.125
    assert sorted(tg) == sorted(jg)
    top = max(np.abs(w).max() for w in jg.values())
    for n, want in jg.items():
        err = np.abs(tg[n] - want).max()
        assert err <= 0.05 * np.abs(want).max() + 1e-3 * top, (n, err)
    np.testing.assert_allclose(tl, jl, rtol=0.05, atol=0.0625)
    assert tl[-1] < tl[0]
    p0 = t.bert.embeddings.word_embeddings.weight
    assert p0.dtype == torch.bfloat16 and id(p0) in to._master_weights
    assert t.bert.embeddings.layer_norm.weight.dtype == torch.float32
    assert ts._scale == js._scale and ts.skipped_steps == js.skipped_steps
