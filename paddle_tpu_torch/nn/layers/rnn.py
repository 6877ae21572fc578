"""Recurrent layers (counterpart of paddle_tpu/nn/layers/rnn.py): the
cells ``LSTMCell``, ``GRUCell`` and ``SimpleRNNCell``, the multi-layer
``LSTM``, ``GRU`` and ``SimpleRNN`` over ``_rnn_scan``, and ``RNN`` /
``BiRNN``, which run a cell over time.

The weights are the reference's and torch's layout: ``weight_ih``
``[gates * H, in]``, ``weight_hh`` ``[gates * H, H]``, ``bias_ih`` and
``bias_hh`` ``[gates * H]`` (``_l{k}`` and ``_l{k}_reverse`` in the
multi-layer layers), each drawn from ``Uniform(-1 / sqrt(H), 1 / sqrt(H))``
with ``generator``. The gates are LSTM's i, f, g, o and GRU's r, z, n
with ``n = tanh(x_n + r * (W_hn h + b_hn))``. ``RNN`` and ``BiRNN`` name
their cells ``cell`` and ``rnn_fw.cell`` / ``rnn_bw.cell``, so weights
carry across by name (``models.convert``).

A step is the reference's ``_lstm_step`` / ``_gru_step`` /
``_simple_step`` op for op, in plain tensor operations; the multi-layer
layers compute each direction's input projection for all steps in one
product before their step loop, as XLA hoists the scan's loop-invariant
operand. Operands of two dtypes promote as JAX promotes them: the
default states of ``get_initial_states`` are float32 whatever the input,
so a bf16 cell given no states computes in float32 (torch's matmul would
refuse the mixed operands).

The reference accepts ``dropout`` and the ``*_attr`` arguments and never
applies them ("Faults of the reference" 12 in ROADMAP.md): the port
raises ``NotImplementedError`` for ``dropout > 0`` and for any ``*_attr``
other than None. ``direction`` is ``"bidirect"`` or ``"bidirectional"``
for two directions (outputs concatenated forward then backward on the
last axis); any other value runs forward, as in the reference.

Layers build on ``device`` (the card when None; raises without one).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.dispatch import primitive
from ...device import resolve_device
from ..initializer import Uniform, create_parameter

_FAULT = "(ROADMAP.md, 'Faults of the reference' 12)"


def _refuse(what, **attrs):
    for key, value in attrs.items():
        if value is not None:
            raise NotImplementedError(
                "%s: %s is not applied by the reference either %s"
                % (what, key, _FAULT))


def _mm(a, w):
    """``a @ w.T`` with both operands in their promoted dtype."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt).T)


def _lstm_gates(xw, h, c, w_hh, b_ih, b_hh):
    """``_lstm_step`` from the input's projection ``xw = x @ w_ih.T``."""
    gates = xw + _mm(h, w_hh) + b_ih + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c2 = f * c + i * torch.tanh(g)
    return o * torch.tanh(c2), c2


def _gru_gates(gi, h, w_hh, b_hh):
    """``_gru_step`` from ``gi = x @ w_ih.T + b_ih``."""
    gh = _mm(h, w_hh) + b_hh
    ir, iz, ic = gi.chunk(3, dim=-1)
    hr, hz, hc = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(ic + r * hc)
    return (1.0 - z) * n + z * h


def _simple_gates(xw, h, w_hh, b_ih, b_hh, activation):
    out = xw + _mm(h, w_hh) + b_ih + b_hh
    return torch.tanh(out) if activation == "tanh" else torch.relu(out)


@primitive
def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One LSTM step: ``(h', c')``."""
    return _lstm_gates(_mm(x, w_ih), h, c, w_hh, b_ih, b_hh)


@primitive
def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    """One GRU step: ``h'``."""
    return _gru_gates(_mm(x, w_ih) + b_ih, h, w_hh, b_hh)


@primitive
def simple_rnn_cell(x, h, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    """One Elman step: ``h'``."""
    return _simple_gates(_mm(x, w_ih), h, w_hh, b_ih, b_hh, activation)


class RNNCellBase(nn.Module):
    def _make_weights(self, input_size, hidden_size, gates, attrs,
                      generator, device, dtype):
        _refuse(type(self).__name__, **attrs)
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=Uniform(-std, std), dtype=dtype,
                  device=resolve_device(device), generator=generator)
        g = gates * hidden_size
        self.weight_ih = create_parameter([g, input_size], **kw)
        self.weight_hh = create_parameter([g, hidden_size], **kw)
        self.bias_ih = create_parameter([g], is_bias=True, **kw)
        self.bias_hh = create_parameter([g], is_bias=True, **kw)

    def get_initial_states(self, batch_ref, shape=None, dtype=None):
        """Zeros ``[batch, hidden_size]``, float32 unless ``dtype`` says
        otherwise (``shape`` is the reference's argument and unused, as
        there)."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return torch.zeros(batch_ref.shape[0], self.hidden_size,
                           dtype=dtype or torch.float32,
                           device=batch_ref.device)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._make_weights(input_size, hidden_size, 4,
                           dict(weight_ih_attr=weight_ih_attr,
                                weight_hh_attr=weight_hh_attr,
                                bias_ih_attr=bias_ih_attr,
                                bias_hh_attr=bias_hh_attr), generator,
                           device, dtype)

    def forward(self, inputs, states=None):
        """``(h, (h, c))``."""
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        h2, c2 = lstm_cell(inputs, h, c, self.weight_ih, self.weight_hh,
                           self.bias_ih, self.bias_hh)
        return h2, (h2, c2)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._make_weights(input_size, hidden_size, 3,
                           dict(weight_ih_attr=weight_ih_attr,
                                weight_hh_attr=weight_hh_attr,
                                bias_ih_attr=bias_ih_attr,
                                bias_hh_attr=bias_hh_attr), generator,
                           device, dtype)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        h2 = gru_cell(inputs, h, self.weight_ih, self.weight_hh,
                      self.bias_ih, self.bias_hh)
        return h2, h2


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self._make_weights(input_size, hidden_size, 1,
                           dict(weight_ih_attr=weight_ih_attr,
                                weight_hh_attr=weight_hh_attr,
                                bias_ih_attr=bias_ih_attr,
                                bias_hh_attr=bias_hh_attr), generator,
                           device, dtype)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        h2 = simple_rnn_cell(inputs, h, self.weight_ih, self.weight_hh,
                             self.bias_ih, self.bias_hh, self.activation)
        return h2, h2


def _run_direction(seq, weights, h, c, mode, activation, reverse):
    """One layer and direction over ``seq [T, B, I]``: ``(ys [T, B, H],
    h_T, c_T)`` (``c_T`` None but for LSTM)."""
    w_ih, w_hh, b_ih, b_hh = weights
    if reverse:
        seq = seq.flip(0)
    xw = _mm(seq, w_ih)
    if mode == "GRU":
        xw = xw + b_ih
    ys = []
    for t in range(seq.shape[0]):
        if mode == "LSTM":
            h, c = _lstm_gates(xw[t], h, c, w_hh, b_ih, b_hh)
        elif mode == "GRU":
            h = _gru_gates(xw[t], h, w_hh, b_hh)
        else:
            h = _simple_gates(xw[t], h, w_hh, b_ih, b_hh, activation)
        ys.append(h)
    ys = torch.stack(ys, 0)
    return (ys.flip(0) if reverse else ys), h, c


@primitive(name="rnn_scan")
def _rnn_scan(x, h0, c0, weights, mode, num_layers, direction, time_major,
              activation="tanh"):
    """``weights``: ``[w_ih, w_hh, b_ih, b_hh]`` for each layer and
    direction in turn. Returns ``(out, h_n)``, and ``c_n`` after them for
    LSTM; ``h_n`` and ``c_n`` are ``[layers * directions, B, H]``."""
    if not time_major:
        x = x.transpose(0, 1)
    num_dir = 2 if direction == "bidirect" else 1
    layer_in = x
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(num_dir):
            idx = layer * num_dir + d
            ys, h_t, c_t = _run_direction(
                layer_in, weights[4 * idx:4 * idx + 4], h0[idx],
                c0[idx] if c0 is not None else None, mode, activation,
                reverse=d == 1)
            outs.append(ys)
            h_finals.append(h_t)
            if c_t is not None:
                c_finals.append(c_t)
        layer_in = outs[0] if num_dir == 1 else torch.cat(outs, -1)
    out = layer_in if time_major else layer_in.transpose(0, 1)
    if mode == "LSTM":
        return out, torch.stack(h_finals, 0), torch.stack(c_finals, 0)
    return out, torch.stack(h_finals, 0)


class _RNNBase(nn.Module):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", attrs=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError(
                "%s: dropout is not applied by the reference either %s"
                % (type(self).__name__, _FAULT))
        _refuse(type(self).__name__, **(attrs or {}))
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.activation = activation
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        gates = {"LSTM": 4, "GRU": 3, "RNN": 1}[mode]
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        device = resolve_device(device)
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                sfx = "_l%d%s" % (layer, "_reverse" if d == 1 else "")
                shapes = (("weight_ih", [gates * hidden_size, in_size]),
                          ("weight_hh", [gates * hidden_size, hidden_size]),
                          ("bias_ih", [gates * hidden_size]),
                          ("bias_hh", [gates * hidden_size]))
                for name, shape in shapes:
                    self.register_parameter(name + sfx, init.create(
                        shape, dtype, device, generator))
                    self._weight_names.append(name + sfx)

    def forward(self, inputs, initial_states=None):
        """``(out, h_n)``, or ``(out, (h_n, c_n))`` for LSTM; the states
        default to zeros of the input's dtype."""
        batch = inputs.shape[1 if self.time_major else 0]
        n = self.num_layers * self.num_directions
        weights = [getattr(self, name) for name in self._weight_names]
        direction = "bidirect" if self.num_directions == 2 else "forward"

        def zeros():
            return inputs.new_zeros(n, batch, self.hidden_size)

        if self.mode == "LSTM":
            h0, c0 = (initial_states if initial_states is not None
                      else (zeros(), zeros()))
            out, h_n, c_n = _rnn_scan(inputs, h0, c0, weights, self.mode,
                                      self.num_layers, direction,
                                      self.time_major, self.activation)
            return out, (h_n, c_n)
        h0 = initial_states if initial_states is not None else zeros()
        return _rnn_scan(inputs, h0, None, weights, self.mode,
                         self.num_layers, direction, self.time_major,
                         self.activation)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 generator=None, device=None, dtype=torch.float32, **attrs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, attrs=attrs,
                         generator=generator, device=device, dtype=dtype)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, *,
                 generator=None, device=None, dtype=torch.float32, **attrs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, attrs=attrs,
                         generator=generator, device=device, dtype=dtype)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", *, generator=None, device=None,
                 dtype=torch.float32, **attrs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         attrs=attrs, generator=generator, device=device,
                         dtype=dtype)


class RNN(nn.Module):
    """``cell`` run over the time axis: ``(outputs stacked on it, final
    states)``. Keyword arguments of ``forward`` are accepted and not
    passed to the cell, as in the reference: a cell that needs more (an
    attention memory) holds it before the call."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, **kwargs):
        t_axis = 0 if self.time_major else 1
        steps = range(inputs.shape[t_axis])
        states = initial_states
        outs = []
        for t in (reversed(steps) if self.is_reverse else steps):
            out, states = self.cell(inputs.select(t_axis, t), states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, t_axis), states


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, **kwargs):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, s_fw = self.rnn_fw(inputs, s_fw)
        o_bw, s_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([o_fw, o_bw], -1), (s_fw, s_bw)
