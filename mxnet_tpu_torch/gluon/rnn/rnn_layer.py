"""The fused multi-layer recurrent layers: RNN, LSTM, GRU.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (MXNet 1.x
``python/mxnet/gluon/rnn/rnn_layer.py``). Each layer and direction keeps
its own ``{l,r}{i}_{i2h,h2h}_{weight,bias}`` parameters, with the JAX
package's names and shapes, so ``.params`` files cross between the
packages; a forward concatenates them into the fused op's flat vector
(every weight, then every bias: ``_collect_params_ordered``) and calls
the ``RNN`` op, which runs cuDNN on the card. ``input_size=0`` defers the
first layer's input width to the first forward. Layouts ``TNC`` (the
default) and ``NTC``.

``dropout`` is applied between layers in training, as MXNet 1.x does
(the JAX layer passes it to an op that ignores it: ROADMAP.md C12).
"""
from __future__ import annotations

from ... import autograd
from ... import ndarray as F
from ...ndarray import NDArray
from ..block import HybridBlock
from ..parameter import DeferredInitializationError

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"invalid layout {layout!r}; TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, nh = self._gates, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param(
                        f"{j}{i}_i2h_weight",
                        (ng * nh, input_size if i == 0 else nh * self._dir),
                        i2h_weight_initializer)
                    self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                         i2h_bias_initializer)
                    self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                         h2h_bias_initializer)

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers}"
                + (", bidirectional" if self._dir == 2 else "") + ")")

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def infer_shape(self, inputs, *args):
        for j in ["l", "r"][:self._dir]:
            self._reg_params[f"{j}0_i2h_weight"].shape = (
                self._gates * self._hidden_size, inputs.shape[-1])

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (``func(shape=..., **kwargs)`` when given): one
        for RNN and GRU, two for LSTM, each (layers * directions,
        batch_size, hidden_size)."""
        if func is None:
            return [F.zeros(info["shape"], **kwargs)
                    for info in self.state_info(batch_size)]
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _collect_params_ordered(self):
        """Pack order: all weights (layer-major, l then r), then all
        biases: the fused op's layout."""
        names = [(i, j) for i in range(self._num_layers)
                 for j in ["l", "r"][:self._dir]]
        ws = [self._reg_params[f"{j}{i}_{k}_weight"].data()
              for i, j in names for k in ("i2h", "h2h")]
        bs = [self._reg_params[f"{j}{i}_{k}_bias"].data()
              for i, j in names for k in ("i2h", "h2h")]
        return ws, bs

    def forward(self, inputs, states=None):
        try:
            ws, bs = self._collect_params_ordered()
        except DeferredInitializationError:
            self.infer_shape(inputs)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            ws, bs = self._collect_params_ordered()
        skip_states = states is None
        if skip_states:
            batch = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, NDArray):
            states = [states]
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        flat = F.concat(*[w.reshape(-1) for w in ws + bs], dim=0)
        out = F.invoke("RNN", inputs, flat, *states,
                       state_size=self._hidden_size,
                       num_layers=self._num_layers, mode=self._mode,
                       bidirectional=self._dir == 2, p=self._dropout,
                       state_outputs=True,
                       training=autograd.is_training())
        outputs = out[0]
        # the fused op always emits (out, h, c); c is LSTM's only
        out_states = list(out[1:3]) if self._mode == "lstm" else [out[1]]
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        if skip_states:
            return outputs
        return outputs, out_states


class RNN(_RNNLayer):
    """Elman RNN layers, ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """LSTM layers (gates ``i, f, g, o``); states ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """GRU layers (gates ``r, z, n``, cuDNN's)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
