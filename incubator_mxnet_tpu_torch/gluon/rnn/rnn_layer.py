"""Fused recurrent layers of the PyTorch port: RNN / LSTM / GRU.

Counterpart of ``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``. Parameter
names are the reference's (``{l,r}{layer}_{i2h,h2h}_{weight,bias}``), so
checkpoints map one to one, and the input-to-hidden weight of layer 0 is
deferred when ``input_size`` is 0 and completed from the first input. The
forward is ``ops.rnn.rnn_forward`` over the layer's parameters, in the TNC
or NTC layout: recorded under ``autograd.record()`` when called with
NDArrays, plain PyTorch when called with tensors (the serving path).

``forward(x)`` returns the output alone; ``forward(x, states)`` (a list, or
the states as separate arguments) returns ``(output, new_states)``. States
are (num_layers * dirs, batch, hidden): ``[h]``, and ``[h, c]`` for LSTM.
"""

import torch

from ... import autograd as _ag
from ...context import resolve_device
from ...ndarray import NDArray, invoke
from ...ops import rnn as _rnn_ops
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be TNC or NTC, got %r" % (layout,))
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param("%s%d_i2h_weight" % (j, i),
                                         (ng * nh, ni), i2h_weight_initializer)
                    self._register_param("%s%d_h2h_weight" % (j, i),
                                         (ng * nh, nh), h2h_weight_initializer)
                    self._register_param("%s%d_i2h_bias" % (j, i),
                                         (ng * nh,), i2h_bias_initializer)
                    self._register_param("%s%d_h2h_bias" % (j, i),
                                         (ng * nh,), h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def _names(self):
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                yield ["%s%d_%s" % (j, i, role) for role in
                       ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]

    def _shape_hook(self, inputs, *args):
        ni = inputs.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._reg_params["%s%d_i2h_weight" % (j, i)].shape_inferred(
                    (ng * nh, ni))
            ni = nh * self._dir
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def _device(self):
        for p in self._reg_params.values():
            if p._data is not None:
                return p._data._t.device
        return None

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states (NDArrays) on ``ctx``; None is the layer's device
        once its parameters exist, else ``cuda:0``. ``func(shape=...,
        **kwargs)`` makes each state instead, where given."""
        from ...ndarray import zeros as nd_zeros
        if ctx is None:
            ctx = self._device()
        return [nd_zeros(info["shape"], ctx=resolve_device(ctx))
                if func is None else func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, *state_args):
        # forward(x), forward(x, [h, c]) or forward(x, h, c)
        if len(state_args) == 1 and isinstance(state_args[0], (list, tuple)):
            states, packed = list(state_args[0]), True
        elif state_args:
            states, packed = list(state_args), False
        else:
            states, packed = None, True
        nd_mode = isinstance(inputs, NDArray)
        x = inputs._t if nd_mode else inputs
        self._shape_hook(x)     # C is axis 2 in either layout
        skip_states = states is None
        if skip_states:
            batch = x.shape[1] if self._layout == "TNC" else x.shape[0]
            states = [torch.zeros(info["shape"], dtype=x.dtype,
                                  device=x.device)
                      for info in self.state_info(batch)]
        weights = [self._reg_params[n].data() for names in self._names()
                   for n in names]
        if not nd_mode:
            weights = [w._t for w in weights]
        n_states = len(states)
        mode, layout, dirs = self._mode, self._layout, self._dir
        dropout, training = self._dropout, _ag.is_training()

        def fn(x, *vals):
            sts, ws = vals[:n_states], iter(vals[n_states:])
            layers = [[dict(wx=next(ws), wh=next(ws), bx=next(ws),
                            bh=next(ws)) for _ in range(dirs)]
                      for _ in range(self._num_layers)]
            if layout == "NTC":
                x = x.transpose(0, 1)
            out, h_n, c_n = _rnn_ops.rnn_forward(
                x, layers, sts[0],
                sts[1] if mode == "lstm" and n_states > 1 else None,
                mode=mode, bidirectional=dirs == 2, p=dropout,
                training=training)
            if layout == "NTC":
                out = out.transpose(0, 1)
            return (out, h_n) if c_n is None else (out, h_n, c_n)

        result = invoke(fn, inputs, *states, *weights) if nd_mode \
            else fn(inputs, *states, *weights)
        if skip_states:
            return result[0]
        new_states = list(result[1:])
        return result[0], (new_states if packed else tuple(new_states))

    def __repr__(self):
        return "%s(%s, %s layers, hidden=%s%s)" % (
            type(self).__name__, self._mode, self._num_layers,
            self._hidden_size, ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Vanilla (Elman) multi-layer RNN with relu / tanh activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, _i(i2h_bias_initializer),
                         _i(h2h_bias_initializer), "rnn_" + activation,
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, _i(i2h_bias_initializer),
                         _i(h2h_bias_initializer), "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, _i(i2h_bias_initializer),
                         _i(h2h_bias_initializer), "gru", **kwargs)


def _i(name_or_init):
    if isinstance(name_or_init, str):
        from ... import initializer as _init
        return _init.create(name_or_init)
    return name_or_init
