"""Recurrent layers: the port of paddle_tpu/nn/layer/rnn.py.

``SimpleRNN``, ``LSTM`` and ``GRU`` over ``RNNBase``, with the JAX
parameter names (``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
``bias_hh_l{k}``, ``_reverse`` for the second direction) and shapes (gates x
hidden by input), every weight and bias drawn from ``Uniform(-1/sqrt(H),
1/sqrt(H))``; the cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) and
the ``RNN``/``BiRNN`` wrappers, which run a cell a step at a time. The gates
are torch's: LSTM input, forget, cell, output; GRU reset, update, new, with
``b_hh`` inside ``r * (...)``.

``rnn_scan`` is the whole multi-layer recurrence. Its plain version is a
loop over time of ``_cell_step``, as the JAX package's ``lax.scan``; on the
card it runs torch's fused recurrent op (cuDNN's, through ``torch._VF``),
which computes the same recurrence with the same gate layout. ``ROUTES``
counts the calls of each. The JAX package computes the scan in XLA, outside
any Pallas kernel.

As in the JAX package, and so documented on each: ``RNNBase`` keeps
``dropout`` and never applies it between layers; ``sequence_length`` is
accepted and ignored by ``RNNBase``, ``RNN`` and ``BiRNN``; ``LSTM`` drops
``proj_size``. Default states take the promoted dtype of the input and the
weights, on the input's device.
"""
from __future__ import annotations

import math

import torch

from ...ops._apply import defop
from ..initializer import Uniform
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell", "LSTMCell",
           "GRUCell", "RNN", "BiRNN"]

#: calls of ``rnn_scan`` by route: torch's fused op on the card, or the loop
ROUTES = {"fused": 0, "loop": 0}

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}
_FUSED = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh", "RNN_RELU": "rnn_relu"}


def _cell_step(mode, x_t, h, c, w_ih, w_hh, b_ih, b_hh):
    """One step of the JAX ``_cell_step``: ``(h_new, c_new)``."""
    if mode == "GRU":
        gx = x_t @ w_ih.t() + (b_ih if b_ih is not None else 0.0)
        gh = h @ w_hh.t() + (b_hh if b_hh is not None else 0.0)
        xr, xz, xn = gx.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    gates = x_t @ w_ih.t() + h @ w_hh.t()
    if b_ih is not None:
        gates = gates + b_ih + b_hh
    if mode == "LSTM":
        i, f, g, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    return (torch.tanh(gates) if mode == "RNN_TANH" else torch.relu(gates)), c


@defop("simple_rnn_cell")
def _simple_rnn_cell(x, h, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    g = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
    return torch.tanh(g) if activation == "tanh" else torch.relu(g)


@defop("lstm_cell")
def _lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    return _cell_step("LSTM", x, h, c, w_ih, w_hh, b_ih, b_hh)


@defop("gru_cell")
def _gru_cell_op(x, h, w_ih, w_hh, b_ih, b_hh):
    return _cell_step("GRU", x, h, None, w_ih, w_hh, b_ih, b_hh)[0]


def _loop(x, init_h, init_c, weights, mode, num_layers, num_dir, per):
    """The plain version: per layer and direction, ``_cell_step`` over time."""
    outputs = x
    h_stack, c_stack = [], []
    idx = 0
    for layer in range(num_layers):
        dir_outs = []
        for d in range(num_dir):
            w_ih, w_hh = weights[idx], weights[idx + 1]
            b_ih, b_hh = (weights[idx + 2], weights[idx + 3]) if per == 4 else (None, None)
            idx += per
            h = init_h[layer * num_dir + d]
            c = init_c[layer * num_dir + d] if init_c is not None else torch.zeros_like(h)
            steps = range(outputs.shape[1])
            ys = [None] * outputs.shape[1]
            for t in (reversed(steps) if d == 1 else steps):
                h, c = _cell_step(mode, outputs[:, t], h, c, w_ih, w_hh, b_ih, b_hh)
                ys[t] = h
            dir_outs.append(torch.stack(ys, 1))
            h_stack.append(h)
            c_stack.append(c)
        outputs = dir_outs[0] if num_dir == 1 else torch.cat(dir_outs, -1)
    return outputs, torch.stack(h_stack), torch.stack(c_stack)


@defop("rnn_scan")
def _rnn_forward(x, init_h, init_c, weights, mode="LSTM", num_layers=1, bidirectional=False,
                 has_bias=True, seq_lens=None):
    """x: (B, T, I). weights: flat list per (layer, direction): [w_ih, w_hh,
    (b_ih, b_hh)]. Returns ``(out, h_n, c_n)`` for an LSTM, else
    ``(out, h_n)``; ``seq_lens`` is ignored, as in the JAX op."""
    num_dir = 2 if bidirectional else 1
    per = 4 if has_bias else 2
    # the JAX scan computes in the promoted dtype of the input and the weights
    dt = torch.promote_types(x.dtype, weights[0].dtype)
    x, init_h = x.to(dt), init_h.to(dt)
    init_c = init_c.to(dt) if init_c is not None else None
    weights = [w.to(dt) for w in weights]
    if x.is_cuda:
        ROUTES["fused"] += 1
        fn = getattr(torch._VF, _FUSED[mode])
        hx = (init_h, init_c) if mode == "LSTM" else init_h
        # dropout 0 and train=True: the same output, and the state the
        # fused op's backward needs
        out = fn(x, hx, weights, has_bias, num_layers, 0.0, True, bidirectional, True)
        return tuple(out) if mode == "LSTM" else tuple(out[:2])
    ROUTES["loop"] += 1
    out, h_n, c_n = _loop(x, init_h, init_c, weights, mode, num_layers, num_dir, per)
    return (out, h_n, c_n) if mode == "LSTM" else (out, h_n)


def _uniform_init(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return Uniform(-std, std)


class RNNBase(Layer):
    """The multi-layer recurrence. ``dropout`` is stored and never applied
    between layers, and ``sequence_length`` is ignored, as in the JAX
    package."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        gates = _GATES[mode] * hidden_size
        init = _uniform_init(hidden_size)
        self._weight_names = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self.num_directions
            for d in range(self.num_directions):
                sfx = f"l{layer}" + ("_reverse" if d == 1 else "")
                for pname, shape, attr, bias in (
                        (f"weight_ih_{sfx}", [gates, in_sz], weight_ih_attr, False),
                        (f"weight_hh_{sfx}", [gates, hidden_size], weight_hh_attr, False),
                        (f"bias_ih_{sfx}", [gates], bias_ih_attr, True),
                        (f"bias_hh_{sfx}", [gates], bias_hh_attr, True)):
                    self.add_parameter(pname, self.create_parameter(
                        shape, attr=attr, is_bias=bias, default_initializer=init))
                    self._weight_names.append(pname)

    def _flat_weights(self):
        return [self._parameters[n] for n in self._weight_names]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        weights = self._flat_weights()
        n_state = self.num_layers * self.num_directions
        # the promoted input x weight dtype, what the cell's products give
        sdtype = torch.promote_types(x.dtype, weights[0].dtype)

        def zeros():
            return torch.zeros(n_state, x.shape[0], self.hidden_size, dtype=sdtype,
                               device=x.device)

        kw = dict(mode=self.mode, num_layers=self.num_layers,
                  bidirectional=self.bidirectional, has_bias=True)
        if self.mode == "LSTM":
            h0, c0 = (zeros(), zeros()) if initial_states is None else initial_states
            out, h_n, c_n = _rnn_forward(x, h0, c0, weights, **kw)
            states = (h_n, c_n)
        else:
            h0 = zeros() if initial_states is None else initial_states
            out, states = _rnn_forward(x, h0, None, weights, **kw)
        if self.time_major:
            out = out.transpose(0, 1)
        return out, states


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers, direction, time_major,
                         dropout, **kwargs)


class LSTM(RNNBase):
    """``proj_size`` is accepted and dropped, as in the JAX package."""

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, **kwargs):
        kwargs.pop("proj_size", None)
        super().__init__("LSTM", input_size, hidden_size, num_layers, direction, time_major,
                         dropout, **kwargs)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers, direction, time_major,
                         dropout, **kwargs)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        """``[batch, hidden_size]`` of ``init_value`` in ``dtype`` (default
        ``batch_ref``'s), on ``batch_ref``'s device; ``shape`` is ignored, as
        in the JAX package."""
        from ...framework import dtype as dtype_mod

        b = batch_ref.shape[batch_dim_idx]
        dt = dtype_mod.convert_dtype(dtype) if dtype is not None else batch_ref.dtype
        return torch.full((b, self.hidden_size), init_value, dtype=dt,
                          device=batch_ref.device)

    def _cell_parameters(self, gates, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr):
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        rows = gates * hidden_size
        self.weight_ih = self.create_parameter([rows, input_size], weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([rows, hidden_size], weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([rows], bias_ih_attr, is_bias=True,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([rows], bias_hh_attr, is_bias=True,
                                             default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._cell_parameters(1, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                              bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _simple_rnn_cell(inputs, states, self.weight_ih, self.weight_hh, self.bias_ih,
                             self.bias_hh, activation=self.activation)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self._cell_parameters(4, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                              bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h, c = self.get_initial_states(inputs), self.get_initial_states(inputs)
        else:
            h, c = states
        h2, c2 = _lstm_cell(inputs, h, c, self.weight_ih, self.weight_hh, self.bias_ih,
                            self.bias_hh)
        return h2, (h2, c2)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self._cell_parameters(3, input_size, hidden_size, weight_ih_attr, weight_hh_attr,
                              bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h2 = _gru_cell_op(inputs, states, self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh)
        return h2, h2


class RNN(Layer):
    """A cell run over time, a step at a time (``is_reverse``: last step
    first). ``sequence_length`` is ignored, as in the JAX package."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        steps = list(x.unbind(1))
        if self.is_reverse:
            steps = steps[::-1]
        states = initial_states
        outs = []
        for s in steps:
            out, states = self.cell(s, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        y = torch.stack(outs, 1)
        return (y.transpose(0, 1) if self.time_major else y), states


class BiRNN(Layer):
    """Two cells, forward and reversed, outputs concatenated on the last
    dim. ``sequence_length`` is ignored, as in the JAX package."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = initial_states if initial_states is not None else (None, None)
        y1, s1 = self.rnn_fw(inputs, st_fw, sequence_length)
        y2, s2 = self.rnn_bw(inputs, st_bw, sequence_length)
        return torch.cat([y1, y2], -1), (s1, s2)
