"""The port's recurrent layers (``paddle_tpu_torch.nn.layer.rnn``) and the
decoders of ``nn.layer.tail`` against the JAX package's, on the CPU, with
the JAX layers' weights carried across by ``weights.from_paddle_tpu_state``
and the same numpy-seeded inputs:

- ``SimpleRNN`` (tanh and relu), ``LSTM`` and ``GRU`` at 1 layer and
  at 2 layers bidirectional, batch-major and time-major, with and without initial states:
  the outputs and final states, and the gradients of a fixed weighted
  sum of them with respect to every parameter, the input and the initial
  states, against JAX's tape;
- the cells (``LSTMCell``, ``GRUCell``, ``SimpleRNNCell``) one step, and
  ``RNN`` / ``BiRNN`` over them, forward and reversed;
- the ``rnn_sequence`` op at the top level;
- the parameter names (``weight_ih_l0`` ... ``_reverse``) and the
  uniform +-1/sqrt(hidden) initialization;
- inter-layer dropout draws from the port's generator: the same seed
  gives the same output, training differs from eval, eval equals JAX;
- ``sequence_length`` is ignored, in JAX and in the port (ROADMAP
  "Health of the reference");
- ``BeamSearchDecoder`` / ``dynamic_decode``: the same greedy tokens and
  final state over a GRU cell with an embedding and an output layer.

Tolerances (float32): outputs and states 1e-5 relative and absolute
(the port does each sequence's input product in one matmul before the
loop, JAX one per step); gradients 1e-4 relative, 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn, weights
from torch_parity import cpu_device  # noqa: F401

torch.set_num_threads(1)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(jlayer):
    return {n: np.asarray(p._value) for n, p in jlayer.named_parameters()}


def _pair(jlayer, tlayer):
    weights.from_paddle_tpu_state(_arrays(jlayer), tlayer)
    return jlayer, tlayer


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v.numpy())


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _flat(e)]
    return [v]


def _weighted_sum(outs, ws, to):
    return sum((o * to(w)).sum() for o, w in zip(outs, ws))


def _check_run(jl, tl, x, states=None, grads=True):
    """Forward both on x (and states), compare every output; then the
    gradients of a fixed weighted sum of the outputs."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_(True)
    jst = tst = None
    if states is not None:
        jst = [paddle.to_tensor(s, stop_gradient=False) for s in states]
        tst = [torch.from_numpy(s).requires_grad_(True) for s in states]
    js = (jst if len(jst) > 1 else jst[0]) if jst else None
    ts = (tuple(tst) if len(tst) > 1 else tst[0]) if tst else None
    jout = _flat(jl(jx, js))
    tout = _flat(tl(tx, ts))
    assert len(jout) == len(tout)
    for i, (g, w) in enumerate(zip(tout, jout)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"out {i}",
                                   **OUT_TOL)
    if not grads:
        return
    r = np.random.default_rng(9)
    ws = [r.standard_normal(tuple(o.shape)).astype(np.float32)
          for o in tout]
    _weighted_sum(jout, ws, paddle.to_tensor).backward()
    _weighted_sum(tout, ws, torch.from_numpy).backward()
    jp = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jp[name].grad),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad),
                               err_msg="input", **GRAD_TOL)
    for i, (a, b) in enumerate(zip(tst or [], jst or [])):
        np.testing.assert_allclose(a.grad.numpy(), _np(b.grad),
                                   err_msg=f"state {i}", **GRAD_TOL)


CONFIGS = [dict(num_layers=1, direction="forward", time_major=False),
           dict(num_layers=2, direction="bidirect", time_major=False),
           dict(num_layers=2, direction="bidirectional", time_major=True)]
LAYERS = [("LSTM", {}), ("GRU", {}), ("SimpleRNN", {}),
          ("SimpleRNN", {"activation": "relu"})]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: f"L{c['num_layers']}-{c['direction']}"
                         f"-{'tm' if c['time_major'] else 'bm'}")
@pytest.mark.parametrize("cls,extra", LAYERS,
                         ids=lambda v: v if isinstance(v, str) else
                         v.get("activation", ""))
@pytest.mark.parametrize("with_states", [False, True],
                         ids=["zero-states", "given-states"])
def test_rnn_layer_outputs_states_and_grads(cls, extra, cfg, with_states):
    paddle.seed(3)
    jl, tl = _pair(getattr(jnn, cls)(5, 6, **cfg, **extra),
                   getattr(nn, cls)(5, 6, **cfg, **extra))
    r = np.random.default_rng(1)
    T, B = 4, 3
    shape = (T, B, 5) if cfg["time_major"] else (B, T, 5)
    x = r.standard_normal(shape).astype(np.float32)
    states = None
    if with_states:
        L = cfg["num_layers"] * (2 if "bi" in cfg["direction"] else 1)
        n = 2 if cls == "LSTM" else 1
        states = [r.standard_normal((L, B, 6)).astype(np.float32)
                  for _ in range(n)]
    _check_run(jl, tl, x, states)


def test_parameter_names_and_uniform_init():
    j = jnn.LSTM(4, 8, num_layers=2, direction="bidirect")
    t = nn.LSTM(4, 8, num_layers=2, direction="bidirect")
    names = [n for n, _ in t.named_parameters()]
    assert names == [n for n, _ in j.named_parameters()]
    assert names[:8] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0", "weight_ih_l0_reverse",
                         "weight_hh_l0_reverse", "bias_ih_l0_reverse",
                         "bias_hh_l0_reverse"]
    shapes = {n: tuple(p.shape) for n, p in t.named_parameters()}
    assert shapes["weight_ih_l1"] == (32, 16)
    assert shapes == {n: tuple(p.shape) for n, p in j.named_parameters()}
    bound = 1 / np.sqrt(8)
    allv = np.concatenate([p.detach().numpy().ravel()
                           for p in t.parameters()])
    assert np.all(np.abs(allv) <= bound) and allv.std() > 0.5 * bound / \
        np.sqrt(3)
    for cls, gates in (("GRUCell", 3), ("LSTMCell", 4),
                       ("SimpleRNNCell", 1)):
        c = getattr(nn, cls)(4, 8)
        assert [n for n, _ in c.named_parameters()] == \
            [n for n, _ in getattr(jnn, cls)(4, 8).named_parameters()]
        assert tuple(c.weight_ih.shape) == (gates * 8, 4)


@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
@pytest.mark.parametrize("with_states", [False, True])
def test_cell_one_step(cls, with_states):
    paddle.seed(4)
    jl, tl = _pair(getattr(jnn, cls)(5, 6), getattr(nn, cls)(5, 6))
    r = np.random.default_rng(2)
    x = r.standard_normal((3, 5)).astype(np.float32)
    states = None
    if with_states:
        states = [r.standard_normal((3, 6)).astype(np.float32)
                  for _ in range(2 if cls == "LSTMCell" else 1)]
    _check_run(jl, tl, x, states)


def test_simple_rnn_cell_relu():
    paddle.seed(4)
    jl, tl = _pair(jnn.SimpleRNNCell(5, 6, activation="relu"),
                   nn.SimpleRNNCell(5, 6, activation="relu"))
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    _check_run(jl, tl, x)


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
@pytest.mark.parametrize("is_reverse,time_major", [(False, False),
                                                   (True, False),
                                                   (False, True)])
def test_rnn_runner_over_a_cell(cell, is_reverse, time_major):
    paddle.seed(5)
    jc, tc = _pair(getattr(jnn, cell)(5, 6), getattr(nn, cell)(5, 6))
    jl = jnn.RNN(jc, is_reverse=is_reverse, time_major=time_major)
    tl = nn.RNN(tc, is_reverse=is_reverse, time_major=time_major)
    x = np.random.default_rng(3).standard_normal((4, 3, 5)).astype(
        np.float32)
    _check_run(jl, tl, x)


def test_birnn_over_two_cells():
    paddle.seed(6)
    jf, tf = _pair(jnn.GRUCell(5, 6), nn.GRUCell(5, 6))
    jb, tb = _pair(jnn.GRUCell(5, 6), nn.GRUCell(5, 6))
    x = np.random.default_rng(4).standard_normal((3, 4, 5)).astype(
        np.float32)
    _check_run(jnn.BiRNN(jf, jb), nn.BiRNN(tf, tb), x)


def test_rnn_sequence_op_at_the_top_level():
    """``paddle.rnn_sequence`` (the op the layers call) with explicit
    weights, an LSTM of 2 bidirectional layers."""
    paddle.seed(7)
    j = jnn.LSTM(5, 6, num_layers=2, direction="bidirect")
    ws = [np.asarray(p._value) for p in j.parameters()]
    r = np.random.default_rng(5)
    x = r.standard_normal((3, 4, 5)).astype(np.float32)
    h0 = r.standard_normal((4, 3, 6)).astype(np.float32)
    c0 = r.standard_normal((4, 3, 6)).astype(np.float32)
    want = paddle.rnn_sequence(
        paddle.to_tensor(x), paddle.to_tensor(h0), paddle.to_tensor(c0),
        [paddle.to_tensor(w) for w in ws], "LSTM", 2, True, 0.0, False)
    got = ptt.rnn_sequence(torch.from_numpy(x), torch.from_numpy(h0),
                           torch.from_numpy(c0),
                           [torch.from_numpy(w.copy()) for w in ws], "LSTM", 2,
                           True, 0.0, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **OUT_TOL)


def test_inter_layer_dropout_draws_from_the_port_generator():
    paddle.seed(8)
    jl, tl = _pair(jnn.GRU(5, 6, num_layers=3, dropout=0.5),
                   nn.GRU(5, 6, num_layers=3, dropout=0.5))
    x = np.random.default_rng(6).standard_normal((2, 5, 5)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    ptt.seed(11)
    a = tl(tx)[0]
    ptt.seed(11)
    b = tl(tx)[0]
    c = tl(tx)[0]
    assert torch.equal(a, b) and not torch.equal(b, c)
    jl.eval()
    tl.eval()
    _check_run(jl, tl, x, grads=False)
    assert not torch.allclose(a, tl(tx)[0])


def test_sequence_length_is_ignored_as_in_jax():
    """A reference quirk, held as stated: both packages run every
    sequence its full length whatever sequence_length says."""
    paddle.seed(9)
    jl, tl = _pair(jnn.LSTM(5, 6), nn.LSTM(5, 6))
    x = np.random.default_rng(7).standard_normal((3, 4, 5)).astype(
        np.float32)
    lens = np.array([4, 2, 1], np.int64)
    jfull = _np(jl(paddle.to_tensor(x))[0])
    jcut = _np(jl(paddle.to_tensor(x),
                  sequence_length=paddle.to_tensor(lens))[0])
    tcut = tl(torch.from_numpy(x),
              sequence_length=torch.from_numpy(lens))[0].detach().numpy()
    np.testing.assert_array_equal(jcut, jfull)
    np.testing.assert_allclose(tcut, jfull, **OUT_TOL)
    assert np.abs(tcut[2, 1:]).max() > 0      # past its length: not masked


def test_dynamic_decode_greedy_over_a_gru_cell():
    paddle.seed(10)
    V, E, H = 7, 4, 6
    jcell, tcell = _pair(jnn.GRUCell(E, H), nn.GRUCell(E, H))
    jemb, temb = _pair(jnn.Embedding(V, E), nn.Embedding(V, E))
    jout, tout = _pair(jnn.Linear(H, V), nn.Linear(H, V))
    h0 = np.random.default_rng(8).standard_normal((3, H)).astype(np.float32)
    jdec = jnn.BeamSearchDecoder(jcell, 1, 0, 4, embedding_fn=jemb,
                                 output_fn=jout)
    tdec = nn.BeamSearchDecoder(tcell, 1, 0, 4, embedding_fn=temb,
                                output_fn=tout)
    jtok, jst = jnn.dynamic_decode(jdec, paddle.to_tensor(h0),
                                   max_step_num=6)
    ttok, tst = nn.dynamic_decode(tdec, torch.from_numpy(h0),
                                  max_step_num=6)
    np.testing.assert_array_equal(ttok.numpy(), _np(jtok))
    assert ttok.dtype == torch.int64 and ttok.shape[0] == 3
    np.testing.assert_allclose(tst.detach().numpy(), _np(jst), **OUT_TOL)


def test_dynamic_decode_stops_at_the_end_token():
    """With an output that always ranks the end token first, one step."""
    cell = nn.GRUCell(1, 3)
    end = nn.BeamSearchDecoder(cell, 0, 2, 1,
                               output_fn=lambda h: torch.tensor(
                                   [[0.0, 0.0, 1.0]]).expand(h.shape[0], 3))
    tok, _ = nn.dynamic_decode(end, torch.zeros(2, 3), max_step_num=5)
    assert tok.tolist() == [[2], [2]]
