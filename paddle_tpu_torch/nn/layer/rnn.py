"""Recurrent layers: the counterpart of ``paddle_tpu/nn/layer/rnn.py`` —
``_cell_step`` (:20), the ``rnn_sequence`` op (:48), the cells
``LSTMCell`` / ``GRUCell`` / ``SimpleRNNCell`` over ``RNNCellBase``
(:93-207), ``_RNNBase`` (:209) with ``SimpleRNN`` / ``LSTM`` / ``GRU``
(:283-305), and the cell runners ``RNN`` (:306) and ``BiRNN`` (:333).

The JAX package runs a sequence as one ``lax.scan`` (XLA's loop, no
Pallas kernel). The port runs the same step loop over torch ops, with
the input projection ``x @ W_ih^T`` of every step done in one product
before the loop (the steps then add ``h @ W_hh^T``); autograd through the
loop is the backward through time.

What the JAX layers do, the port does:

- paddle's GRU applies the hidden bias inside the reset product:
  ``n = tanh(x W_ic + b_ic + r * (h W_hc + b_hc))`` (:31-41);
- the multi-layer layers name their parameters ``weight_ih_l{k}``,
  ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}`` with a
  ``_reverse`` suffix for the backward direction, every one drawn
  uniform in +-1/sqrt(hidden_size), biases too;
- states are ``[num_layers * num_directions, B, H]`` (an LSTM's a pair
  (h, c));
- dropout between layers (training only) draws from the port's
  generator of the input's device;
- ``sequence_length`` is taken and ignored (:250, :315, :340): every
  sequence runs its full length, with no masking.

Layers with parameters take ``device=`` and ``dtype=`` keyword-only
(``device=None``: the current device).
"""

from __future__ import annotations

import math

import torch

from ...ops.registry import register_op
from .. import initializer as I
from ..functional.common import _keep_mask
from ..layers import Layer

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _cell_step(mode, xw, h, c, whh, bhh):
    """One step from the input projection `xw` (``x W_ih^T``, plus
    ``b_ih`` for a GRU): the new (h, c); c is h but for an LSTM."""
    if mode == "GRU":
        xr, xz, xc = xw.chunk(3, dim=-1)
        hg = h @ whh.T
        if bhh is not None:
            hg = hg + bhh
        hr, hz, hc = hg.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xc + r * hc)
        h = (1 - z) * n + z * h
        return h, h
    gates = xw + h @ whh.T
    if bhh is not None:
        gates = gates + bhh
    if mode == "LSTM":
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return h, c
    h = torch.tanh(gates) if mode == "RNN_TANH" else torch.relu(gates)
    return h, h


def _input_projection(seq, wih, bih):
    """``seq @ W_ih^T`` for every step at once, with b_ih: [T, B, G*H].
    (The LSTM's and the simple RNN's gates add b_ih after the hidden
    product, b_ih + b_hh; the sums are the JAX step's to rounding.)"""
    xw = seq @ wih.T
    return xw + bih if bih is not None else xw


@register_op("rnn_sequence")
def rnn_sequence(x, h0, c0, weights, mode="LSTM", num_layers=1,
                 bidirectional=False, dropout=0.0, training=True,
                 time_major=False, has_bias=True, *, generator=None):
    """x: [B, T, I] ([T, B, I] when time_major). weights: a flat list per
    (layer, direction) of wih, whh[, bih, bhh]. h0/c0: [L*D, B, H].
    Returns (out [B, T, D*H], h [L*D, B, H], c [L*D, B, H])."""
    if not time_major:
        x = x.transpose(0, 1)                       # T, B, I
    num_dir = 2 if bidirectional else 1
    per = 4 if has_bias else 2
    out = x
    hs, cs = [], []
    for layer in range(num_layers):
        dir_outs = []
        for d in range(num_dir):
            idx = (layer * num_dir + d) * per
            wih, whh = weights[idx], weights[idx + 1]
            bih = weights[idx + 2] if has_bias else None
            bhh = weights[idx + 3] if has_bias else None
            h = h0[layer * num_dir + d]
            c = c0[layer * num_dir + d] if mode == "LSTM" else h
            seq = out.flip(0) if d == 1 else out
            xw = _input_projection(seq, wih, bih)
            ys = []
            for t in range(xw.shape[0]):
                h, c = _cell_step(mode, xw[t], h, c, whh, bhh)
                ys.append(h)
            ys = torch.stack(ys)
            dir_outs.append(ys.flip(0) if d == 1 else ys)
            hs.append(h)
            cs.append(c)
        out = torch.cat(dir_outs, dim=-1) if num_dir == 2 else dir_outs[0]
        if dropout > 0 and training and layer < num_layers - 1:
            keep = _keep_mask(out.shape, dropout, out, generator)
            out = torch.where(keep, out / (1 - dropout),
                              torch.zeros_like(out))
    if not time_major:
        out = out.transpose(0, 1)
    return out, torch.stack(hs), torch.stack(cs)


def _uniform_params(layer, gates, input_size, hidden_size, attrs, device,
                    suffix=""):
    """weight_ih, weight_hh, bias_ih, bias_hh (`suffix` appended to each
    name), each uniform in +-1/sqrt(hidden_size), as the JAX layers draw
    them."""
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    shapes = ([gates * hidden_size, input_size],
              [gates * hidden_size, hidden_size],
              [gates * hidden_size], [gates * hidden_size])
    names = []
    for base, shape, attr in zip(("weight_ih", "weight_hh", "bias_ih",
                                  "bias_hh"), shapes, attrs):
        p = layer.create_parameter(shape, attr, is_bias=len(shape) == 1,
                                   default_initializer=u, device=device)
        layer.add_parameter(base + suffix, p)
        names.append(base + suffix)
    return names


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """[B, hidden_size] filled with init_value, B read from
        `batch_ref`'s dim batch_dim_idx, on its device."""
        from ...framework.dtype import convert_dtype
        b = batch_ref.shape[batch_dim_idx]
        return torch.full((b, self.hidden_size), init_value,
                          dtype=convert_dtype(dtype or "float32"),
                          device=batch_ref.device)


class _Cell(RNNCellBase):
    MODE = None

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.input_size = input_size
        self.hidden_size = hidden_size
        _uniform_params(self, _GATES[self.MODE], input_size, hidden_size,
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr), device)

    def _step(self, inputs, h, c):
        xw = _input_projection(inputs, self.weight_ih, self.bias_ih)
        return _cell_step(self.MODE, xw, h, c, self.weight_hh, self.bias_hh)


class LSTMCell(_Cell):
    """One LSTM step: (h, (h, c)); zero states when `states` is None."""

    MODE = "LSTM"

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs, dtype=inputs.dtype)
            c = self.get_initial_states(inputs, dtype=inputs.dtype)
        else:
            h, c = states
        h, c = self._step(inputs, h, c)
        return h, (h, c)


class GRUCell(_Cell):
    """One paddle GRU step (the hidden bias inside the reset product):
    (h, h)."""

    MODE = "GRU"

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs, dtype=inputs.dtype)
        h, _ = self._step(inputs, h, h)
        return h, h


class SimpleRNNCell(_Cell):
    """One tanh (or relu) step: (h, h)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        self.activation = activation
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs, dtype=inputs.dtype)
        h, _ = self._step(inputs, h, h)
        return h, h


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or torch.get_default_dtype())
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d == 1 else "")
                self._weight_names += _uniform_params(
                    self, _GATES[mode], in_size, hidden_size,
                    (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr), device, sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """(out, h) (an LSTM's (out, (h, c))); zero initial states when
        none are given. sequence_length is ignored, as in JAX."""
        b = inputs.shape[1 if self.time_major else 0]
        L = self.num_layers * self.num_directions
        if initial_states is None:
            h0 = inputs.new_zeros((L, b, self.hidden_size))
            c0 = inputs.new_zeros((L, b, self.hidden_size))
        elif self.mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0 = c0 = initial_states
        weights = [self._parameters[n] for n in self._weight_names]
        out, h, c = rnn_sequence(inputs, h0, c0, weights, self.mode,
                                 self.num_layers, self.num_directions == 2,
                                 self.dropout, self.training,
                                 self.time_major, True)
        return (out, (h, c)) if self.mode == "LSTM" else (out, h)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class RNN(Layer):
    """Runs a cell over a sequence, step by step (reversed when
    is_reverse); returns (out stacked on the time axis, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = []
        for t in steps:
            out, states = self.cell(inputs.select(time_axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=time_axis), states


class BiRNN(Layer):
    """A forward and a reversed ``RNN``; outputs concatenated on the
    last dim, states (forward, backward)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_states, bw_states = (None, None) if initial_states is None \
            else initial_states
        out_fw, fw = self.rnn_fw(inputs, fw_states)
        out_bw, bw = self.rnn_bw(inputs, bw_states)
        return torch.cat([out_fw, out_bw], dim=-1), (fw, bw)
