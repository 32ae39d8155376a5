"""Recurrent cells: one step at a time, or unrolled.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (MXNet 1.x
``python/mxnet/gluon/rnn/rnn_cell.py``): ``RecurrentCell`` (``begin_state``,
``unroll``), ``RNNCell``, ``LSTMCell`` (gates ``i, f, c, o``),
``GRUCell`` (``r, z, n``), ``SequentialRNNCell``, ``BidirectionalCell``,
``DropoutCell``, ``ResidualCell`` and ``ZoneoutCell``, with the JAX
package's parameter names (``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``). A cell's ``__call__`` runs its forward directly, as in the
JAX package: ``hybridize()`` captures the block that calls the cells.

``DropoutCell`` and ``ZoneoutCell`` draw their masks from ``mx.random``'s
generator of the input's device (the JAX cells split threefry keys), so
``mx.random.seed`` repeats them and a CUDA graph replays fresh ones.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as F
from ... import random as _random
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "ZoneoutCell"]


def _steps(inputs, length, layout):
    """``(list of (N, C) steps, batch size)`` of an NDArray in
    ``layout``, or of a list of steps."""
    if isinstance(inputs, NDArray):
        axis = layout.find("T")
        return ([inputs.slice_axis(axis, i, i + 1).squeeze(axis)
                 for i in range(length)], inputs.shape[layout.find("N")])
    seq = list(inputs)
    return seq, seq[0].shape[0]


class RecurrentCell(HybridBlock):
    """Base cell: ``state_info``, ``begin_state`` and ``unroll``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``func(shape=..., **kwargs)`` when given), one
        per ``state_info`` entry."""
        if self._modified:
            raise RuntimeError("after applying a modifier cell (e.g. "
                               "ZoneoutCell) the base cell cannot be called "
                               "directly; call the modifier cell instead")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if func is None:
                states.append(F.zeros(info["shape"], **kwargs))
            else:
                states.append(func(shape=info["shape"], **kwargs))
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return self.forward(inputs, states)

    def forward(self, inputs, states):
        params = self._materialize_params(inputs, states)
        return self.hybrid_forward(F, inputs, states, **params)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` (an NDArray
        in ``layout``, or a list of steps); returns ``(outputs,
        states)``, the outputs stacked along the time axis when
        ``merge_outputs`` (or ``valid_length``, which zeroes the steps
        past each row's length)."""
        self.reset()
        axis = layout.find("T")
        seq, batch_size = _steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=seq[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = F.stack(*outputs, axis=axis)
            if axis != 0:
                stacked = stacked.swapaxes(0, axis)
            stacked = F.invoke("SequenceMask", stacked, valid_length,
                               use_sequence_length=True, value=0.0)
            outputs = stacked.swapaxes(0, axis) if axis != 0 else stacked
            merge_outputs = True
        if merge_outputs and not isinstance(outputs, NDArray):
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, inputs, activation):
        if callable(activation):
            return activation(inputs)
        return F.Activation(inputs, act_type=str(activation))


class _BaseUnitCell(RecurrentCell):
    """The weights of a single RNN, LSTM or GRU cell."""

    def __init__(self, hidden_size, ngates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = ngates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (self.i2h_weight.shape[0], inputs.shape[-1])

    def _projections(self, inputs, prev, n, i2h_weight, h2h_weight,
                     i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias, num_hidden=n)
        return i2h, h2h


class RNNCell(_BaseUnitCell):
    """Elman cell: ``act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F_, inputs, states, **params):
        i2h, h2h = self._projections(inputs, states[0], self._hidden_size,
                                     **params)
        output = self._get_activation(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_BaseUnitCell):
    """LSTM cell, gates ``i, f, c, o``; states ``[h, c]``."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F_, inputs, states, **params):
        h = self._hidden_size
        i2h, h2h = self._projections(inputs, states[0], 4 * h, **params)
        gates = i2h + h2h
        in_gate = gates.slice_axis(-1, 0, h).sigmoid()
        forget_gate = gates.slice_axis(-1, h, 2 * h).sigmoid()
        in_transform = gates.slice_axis(-1, 2 * h, 3 * h).tanh()
        out_gate = gates.slice_axis(-1, 3 * h, 4 * h).sigmoid()
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * next_c.tanh()
        return next_h, [next_h, next_c]


class GRUCell(_BaseUnitCell):
    """GRU cell, gates ``r, z, n`` (cuDNN's convention)."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F_, inputs, states, **params):
        h = self._hidden_size
        prev = states[0]
        i2h, h2h = self._projections(inputs, prev, 3 * h, **params)
        reset = (i2h.slice_axis(-1, 0, h) + h2h.slice_axis(-1, 0, h)) \
            .sigmoid()
        update = (i2h.slice_axis(-1, h, 2 * h)
                  + h2h.slice_axis(-1, h, 2 * h)).sigmoid()
        next_h_tmp = (i2h.slice_axis(-1, 2 * h, 3 * h)
                      + reset * h2h.slice_axis(-1, 2 * h, 3 * h)).tanh()
        next_h = (1.0 - update) * next_h_tmp + update * prev
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [s for cell in self._children.values()
                for s in cell.begin_state(batch_size, **kwargs)]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, new_states = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(new_states)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class DropoutCell(RecurrentCell):
    """Dropout on the step's input in training (``axes`` share the
    mask); no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0 and autograd.is_training():
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias() + "_")
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(batch_size, **kwargs)
        finally:
            self.base_cell._modified = True


class ResidualCell(_ModifierCell):
    """``cell(x) + x``."""

    def _alias(self):
        return "residual"

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class ZoneoutCell(_ModifierCell):
    """In training, keeps each output and state element of the previous
    step with probability ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states

        def keep_new(p, like):
            """True where the new value is kept (probability 1 - p)."""
            t = like._data
            gen = _random.generator(t.device)
            return NDArray(torch.rand(t.shape, generator=gen,
                                      device=t.device) < 1 - p)

        po, ps = self.zoneout_outputs, self.zoneout_states
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros(next_output.shape, ctx=next_output.context)
        output = F.where(keep_new(po, next_output), next_output,
                         prev_output) if po > 0 else next_output
        new_states = [F.where(keep_new(ps, ns), ns, s) if ps > 0 else ns
                      for ns, s in zip(next_states, states)]
        self._prev_output = output
        return output, new_states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence, forwards and backwards, outputs
    concatenated; unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        lc, rc = self._children["l_cell"], self._children["r_cell"]
        return lc.state_info(batch_size) + rc.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        lc, rc = self._children["l_cell"], self._children["r_cell"]
        return lc.begin_state(batch_size, **kwargs) + \
            rc.begin_state(batch_size, **kwargs)

    def forward(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        lc, rc = self._children["l_cell"], self._children["r_cell"]
        seq, batch_size = _steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=seq[0].context)
        n_l = len(lc.state_info())
        l_out, l_states = lc.unroll(length, seq, begin_state[:n_l],
                                    layout=layout, merge_outputs=False)
        r_out, r_states = rc.unroll(length, list(reversed(seq)),
                                    begin_state[n_l:], layout=layout,
                                    merge_outputs=False)
        outputs = [F.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
