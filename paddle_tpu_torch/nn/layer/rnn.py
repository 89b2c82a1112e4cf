"""Recurrent layers: the SimpleRNN / LSTM / GRU cells and the ``RNN`` /
``BiRNN`` / ``RNNBase`` wrappers (counterpart of
``paddle_tpu/nn/layer/rnn.py``).

Parameter layout and gate order are the JAX package's (Paddle's): LSTM
gates i, f, g, o; GRU gates r, z, c with ``h = (h_prev - c) * z + c``;
``weight_ih`` is ``[gates * hidden, input]``, so a JAX state dict loads
under the same names (``_rnn_layers.0.cell_fw.weight_ih`` ...).

The JAX package runs a known cell over the sequence as one
``lax.scan``; here it is a loop over time in PyTorch (the card's GEMMs
and elementwise kernels, and autograd through the loop). The input
product ``x @ weight_ih^T`` is one GEMM over every step ahead of the
loop (the JAX body adds it first, so the sums keep its order); each
step adds ``h @ weight_hh^T`` and the biases. With ``sequence_length``
a finished row keeps its carry and outputs zeros (the JAX select).
cuDNN's fused RNN is not used: it runs TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, and a fused RNN kernel is
work for a later PR.
"""
from __future__ import annotations

import math

import torch

from ...core import dtypes as _dt
from ..initializer import Uniform
from .common import Dropout, LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "RNNBase", "SimpleRNN", "LSTM", "GRU"]


def _gates(pre, h, w_hh, b_ih, b_hh):
    """``(x W_ih^T + h W_hh^T) + b_ih + b_hh`` with the input product
    ``pre`` given: the JAX body's order of sums."""
    g = pre + h @ w_hh.t()
    if b_ih is not None:
        g = g + b_ih
    if b_hh is not None:
        g = g + b_hh
    return g


def _lstm_step(pre, h, c, w_hh, b_ih, b_hh):
    i, f, gg, o = torch.chunk(_gates(pre, h, w_hh, b_ih, b_hh), 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(xg, h, w_hh, b_hh):
    """``xg`` holds ``x W_ih^T + b_ih`` (the JAX body adds b_ih there)."""
    hg = h @ w_hh.t()
    if b_hh is not None:
        hg = hg + b_hh
    x_r, x_z, x_c = torch.chunk(xg, 3, dim=-1)
    h_r, h_z, h_c = torch.chunk(hg, 3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    c = torch.tanh(x_c + r * h_c)
    return (h - c) * z + c


def _act(name):
    return torch.tanh if name == "tanh" else torch.relu


def _std_init(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return Uniform(-std, std)


class RNNCellBase(Layer):
    """Base of the single-step cells."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dtype = (_dt.convert_dtype(dtype) or self._dtype
                 or _dt.get_default_dtype())

        def build(s):
            if isinstance(s, (list, tuple)) and s and isinstance(
                    s[0], (list, tuple)):
                return tuple(build(x) for x in s)
            return torch.full([batch] + [int(d) for d in s], init_value,
                              dtype=dtype, device=batch_ref.device)

        return build(shape)

    def _make(self, gates, input_size, hidden_size, weight_ih_attr,
              weight_hh_attr, bias_ih_attr, bias_hh_attr):
        if hidden_size <= 0:
            raise ValueError("hidden_size must be positive")
        self.input_size, self.hidden_size = input_size, hidden_size
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=init)
        self.bias_ih = (None if bias_ih_attr is False else
                        self.create_parameter([gates * hidden_size],
                                              bias_ih_attr, is_bias=True,
                                              default_initializer=init))
        self.bias_hh = (None if bias_hh_attr is False else
                        self.create_parameter([gates * hidden_size],
                                              bias_hh_attr, is_bias=True,
                                              default_initializer=init))

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(RNNCellBase):
    r"""``h = act(x W_ih^T + h W_hh^T + b_ih + b_hh)``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation
        self._make(1, input_size, hidden_size, weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _act(self.activation)(_gates(
            inputs @ self.weight_ih.t(), states, self.weight_hh,
            self.bias_ih, self.bias_hh))
        return h, h


class LSTMCell(RNNCellBase):
    r"""Gates i, f, g, o over ``[4 * hidden, input]`` weights; states
    ``(h, c)``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._make(4, input_size, hidden_size, weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        h, c = _lstm_step(inputs @ self.weight_ih.t(), h, c, self.weight_hh,
                          self.bias_ih, self.bias_hh)
        return h, (h, c)


class GRUCell(RNNCellBase):
    r"""Gates r, z, c; ``h = (h_prev - c) * z + c``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._make(3, input_size, hidden_size, weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        xg = inputs @ self.weight_ih.t()
        if self.bias_ih is not None:
            xg = xg + self.bias_ih
        h = _gru_step(xg, states, self.weight_hh, self.bias_hh)
        return h, h


def _run_cell(cell, x, states, reverse, seq_len):
    """A known cell over time-major ``x [T, B, I]`` from ``states`` (a
    tuple of ``[B, H]`` carries): ``(outputs [T, B, H], final carries)``."""
    T = x.shape[0]
    pre = x @ cell.weight_ih.t()            # one GEMM for every step
    gru = isinstance(cell, GRUCell)
    if gru and cell.bias_ih is not None:
        pre = pre + cell.bias_ih
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if isinstance(cell, LSTMCell):
            new = _lstm_step(pre[t], *states, cell.weight_hh, cell.bias_ih,
                             cell.bias_hh)
        elif gru:
            new = (_gru_step(pre[t], states[0], cell.weight_hh,
                             cell.bias_hh),)
        else:
            new = (_act(cell.activation)(_gates(
                pre[t], states[0], cell.weight_hh, cell.bias_ih,
                cell.bias_hh)),)
        if seq_len is not None:
            valid = (t < seq_len)[:, None]
            new = tuple(torch.where(valid, n, o) for n, o in zip(new, states))
            outs[t] = torch.where(valid, new[0], torch.zeros_like(new[0]))
        else:
            outs[t] = new[0]
        states = new
    return torch.stack(outs), states


_KNOWN = (SimpleRNNCell, LSTMCell, GRUCell)


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *leaves)
                              for leaves in zip(*trees))
    return fn(*trees)


class RNN(Layer):
    """A cell run over a sequence: a known cell through the loop above,
    any other cell step by step through its ``forward``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                batch_ref=inputs, dtype=inputs.dtype,
                batch_dim_idx=1 if self.time_major else 0)
        if type(self.cell) in _KNOWN and not kwargs:
            lstm = isinstance(self.cell, LSTMCell)
            states = tuple(initial_states) if lstm else (initial_states,)
            x = inputs if self.time_major else inputs.transpose(0, 1)
            seq = (None if sequence_length is None
                   else sequence_length.to(x.device))
            outs, final = _run_cell(self.cell, x, states, self.is_reverse,
                                    seq)
            if not self.time_major:
                outs = outs.transpose(0, 1)
            return outs, (tuple(final) if lstm else final[0])
        return self._loop(inputs, initial_states, sequence_length, **kwargs)

    def _loop(self, inputs, states, sequence_length, **kwargs):
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        outs = [None] * T
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, new_states = self.cell(x_t, states, **kwargs)
            if sequence_length is not None:
                valid = (t < sequence_length.to(inputs.device)).to(
                    inputs.dtype)

                def mask(n, o=None, v=valid):
                    vb = v.reshape([v.shape[0]] + [1] * (n.ndim - 1))
                    return n * vb if o is None else n * vb + o * (1 - vb)

                out = _tree_map(mask, out)
                new_states = _tree_map(mask, new_states, states)
            outs[t] = out
            states = new_states
        return _tree_map(lambda *leaves: torch.stack(leaves, time_axis),
                         *outs), states


class BiRNN(Layer):
    """A forward and a backward cell over the same input, outputs
    concatenated; states ``(forward, backward)``. The cells are its
    sublayers (``cell_fw`` / ``cell_bw``), as their names in a JAX state
    dict say; the two ``RNN`` runners around them are not."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        object.__setattr__(self, "rnn_fw", RNN(cell_fw, False, time_major))
        object.__setattr__(self, "rnn_bw", RNN(cell_bw, True, time_major))
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length,
                                    **kwargs)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length,
                                    **kwargs)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class RNNBase(Layer):
    """A multi-layer, optionally bidirectional RNN: one cell per (layer,
    direction), states stacked ``[num_layers * num_directions, B, H]``,
    dropout between layers (the threefry dropout, as the JAX package's)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError("direction should be forward or bidirect "
                             "(or bidirectional)")
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        self.state_components = 2 if mode == "LSTM" else 1
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr)

        def new_cell(isz):
            if mode == "LSTM":
                return LSTMCell(isz, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(isz, hidden_size, **kw)
            return SimpleRNNCell(isz, hidden_size, activation, **kw)

        layers = []
        for i in range(num_layers):
            isz = input_size if i == 0 else hidden_size * self.num_directions
            layers.append(BiRNN(new_cell(isz), new_cell(isz), time_major)
                          if self.bidirectional
                          else RNN(new_cell(isz), time_major=time_major))
        self._rnn_layers = LayerList(layers)
        self._dropout_layer = Dropout(dropout) if dropout > 0 else None

    def _split_states(self, states):
        n = self.num_layers * self.num_directions
        if self.mode == "LSTM":
            flat = list(zip(torch.unbind(states[0], 0),
                            torch.unbind(states[1], 0)))
        else:
            flat = list(torch.unbind(states, 0))
        assert len(flat) == n, (len(flat), n)
        if self.bidirectional:
            return [(flat[2 * i], flat[2 * i + 1])
                    for i in range(self.num_layers)]
        return flat

    def _concat_states(self, per_layer):
        flat = []
        for st in per_layer:
            flat.extend(st if self.bidirectional else [st])
        if self.mode == "LSTM":
            return (torch.stack([s[0] for s in flat]),
                    torch.stack([s[1] for s in flat]))
        return torch.stack(flat)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        B = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            zero = torch.zeros(
                [self.num_layers * self.num_directions, B,
                 self.hidden_size], dtype=inputs.dtype, device=inputs.device)
            initial_states = (zero, torch.zeros_like(zero)) \
                if self.mode == "LSTM" else zero
        per_layer = self._split_states(initial_states)
        out, finals = inputs, []
        for i, rnn_layer in enumerate(self._rnn_layers):
            if i > 0 and self._dropout_layer is not None:
                out = self._dropout_layer(out)
            out, st = rnn_layer(out, per_layer[i], sequence_length)
            finals.append(st)
        return out, self._concat_states(finals)


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, "tanh",
                         weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)
