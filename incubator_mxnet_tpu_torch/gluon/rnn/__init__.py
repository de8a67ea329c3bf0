"""gluon.rnn of the PyTorch port (counterpart of
``incubator_mxnet_tpu/gluon/rnn/``): the fused layers ``RNN``, ``LSTM`` and
``GRU``. The cells of ``rnn_cell.py`` wait for ROADMAP Queue 1 item 10;
asking for one of their names raises NotImplementedError."""

from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU"]

_CELLS = ("RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
          "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
          "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
          "BidirectionalCell")


def __getattr__(name):
    if name in _CELLS:
        raise NotImplementedError("gluon.rnn.%s: the recurrent cells are not "
                                  "ported yet (ROADMAP Queue 1 item 10)"
                                  % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
