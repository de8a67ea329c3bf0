"""Word-level LSTM language model (BASELINE config 3: the PTB LSTM of the
reference's example/rnn/word_lm: 650 hidden, 2 layers, tied embedding,
dropout 0.5, vocabulary 10000).

Counterpart of ``incubator_mxnet_tpu/models/lstm_lm.py``, on the port's
gluon layers: the parameter names (``encoder.weight``, ``rnn.l0_i2h_weight``,
..., ``decoder.bias``) are the JAX package's, and with ``tie_weights`` the
decoder's weight is the embedding's Parameter. Called with NDArrays it
records under ``autograd.record()``; with tensors it runs as plain PyTorch
(the serving path).
"""

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock

__all__ = ["RNNModel", "lstm_lm_ptb"]


class RNNModel(HybridBlock):
    def __init__(self, mode="lstm", vocab_size=10000, num_embed=650,
                 num_hidden=650, num_layers=2, dropout=0.5, tie_weights=True,
                 **kwargs):
        super().__init__(**kwargs)
        self._num_hidden = num_hidden
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab_size, num_embed,
                                        weight_initializer=None,
                                        prefix="embed_")
            if mode == "lstm":
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed, prefix="rnn_")
            elif mode == "gru":
                self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed, prefix="rnn_")
            else:
                self.rnn = rnn.RNN(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed, prefix="rnn_")
            if tie_weights:
                if num_embed != num_hidden:
                    raise ValueError("tied embedding requires num_embed == "
                                     "num_hidden, got %d and %d"
                                     % (num_embed, num_hidden))
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        params=self.encoder.params,
                                        prefix="embed_")
            else:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        prefix="decoder_")

    def begin_state(self, batch_size, **kwargs):
        return self.rnn.begin_state(batch_size, **kwargs)

    def forward(self, inputs, states):
        """inputs: (T, N) int tokens; returns (logits (T, N, V), states)."""
        emb = self.drop(self.encoder(inputs))
        output, states = self.rnn(emb, states)
        output = self.drop(output)
        return self.decoder(output), states

    def hybrid_forward(self, F, inputs, *states):
        return self.forward(inputs, list(states))


def lstm_lm_ptb(**kwargs):
    cfg = dict(mode="lstm", vocab_size=10000, num_embed=650, num_hidden=650,
               num_layers=2, dropout=0.5, tie_weights=True)
    cfg.update(kwargs)
    return RNNModel(**cfg)
