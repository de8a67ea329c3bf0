"""BERT encoder and pretraining heads as PyTorch modules.

Counterpart of ``incubator_mxnet_tpu/models/bert.py``: ``BERTModel`` (the
encoder) and ``BERTForPretrain`` (the MLM and NSP heads, gather-first MLM,
tied decoder), without ring attention or the tensor-parallel rules, which
come with later slices. Parameter names are exactly the JAX package's
``_collect_params_with_prefix()`` keys (``word_embed.weight``,
``encoder.layers.0.attention.query.weight``, ...; ``bert.`` before them in
``BERTForPretrain``), dense weights are (out, in) and LayerNorm holds
``gamma``/``beta`` with eps 1e-5, so weights cross between the packages by
name: ``params_from_jax``, ``pretrain_params_from_jax`` and the models'
``load_params``.

Attention follows the JAX package's choice: the flash-attention kernel when
T >= ``MXTPU_FLASH_MIN_T`` (default 512), attention dropout is 0 and
``MXTPU_DISABLE_FLASH`` is not 1; otherwise scores, the additive
``(1 - mask) * -1e30`` padding bias and the softmax kernel. The kernel takes
any T, so the JAX package's ``T % 128`` condition is gone. Both paths, and
LayerNorm, are differentiable through ``torch.autograd``.

The modules are built in inference mode (``eval()``), as the JAX package's
forward runs outside ``autograd.record()``; ``train()`` turns dropout on.
They run in the dtype their parameters carry: under ShardedTrainer's bf16
or fp16 ``compute_dtype`` every product, LayerNorm and softmax runs in that
dtype (the kernels' 16-bit flavours), the padding bias follows PyTorch's
promotion as the JAX package's follows jnp's (a 16-bit mask keeps 16-bit
scores; -1e30 is a bf16 value and -inf in fp16, which the softmax turns into
exact zeros as jax.nn.softmax does), and the flash path's key bias stays
fp32.
"""

import math
import os

import numpy as np
import torch
from torch import nn

from ..context import resolve_device
from ..ops.kernels.flash_attention import flash_attention
from ..ops.nn import (activation, embedding, fully_connected, layer_norm,
                      leaky_relu, softmax)

__all__ = ["BERTModel", "BERTForPretrain", "BERTEncoder",
           "TransformerEncoderLayer", "MultiHeadAttention", "PositionwiseFFN",
           "bert_base", "bert_large", "bert_param_shapes",
           "pretrain_param_shapes", "params_from_jax",
           "pretrain_params_from_jax", "use_flash"]


def use_flash(T, dropout_rate):
    """The JAX package's attention choice (models/bert.py), less its TPU
    tiling rule: flash from ``MXTPU_FLASH_MIN_T`` up, without attention
    dropout, unless ``MXTPU_DISABLE_FLASH=1``."""
    try:
        min_t = int(os.environ.get("MXTPU_FLASH_MIN_T", "512"))
    except ValueError:
        min_t = 512
    return (dropout_rate == 0
            and os.environ.get("MXTPU_DISABLE_FLASH", "0") != "1"
            and T >= min_t)


class Dense(nn.Module):
    """y = act(x W^T + b), weight (units, in_units)."""

    def __init__(self, in_units, units, activation=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(units, in_units, device=device))
        self.bias = nn.Parameter(torch.zeros(units, device=device))
        self._act = activation

    def forward(self, x):
        out = fully_connected(x, self.weight, self.bias, flatten=False)
        return activation(out, self._act) if self._act else out


class LayerNorm(nn.Module):
    def __init__(self, units, epsilon=1e-5, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(units, device=device))
        self.beta = nn.Parameter(torch.zeros(units, device=device))
        self._eps = epsilon

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, axis=-1, eps=self._eps)


class Embedding(nn.Module):
    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(input_dim, output_dim, device=device))

    def forward(self, x):
        return embedding(x, self.weight)


class MultiHeadAttention(nn.Module):
    def __init__(self, units, num_heads, dropout=0.0, device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError("units %d is not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self.query = Dense(units, units, device=device)
        self.key = Dense(units, units, device=device)
        self.value = Dense(units, units, device=device)
        self.proj = Dense(units, units, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        B, T = x.shape[0], x.shape[1]
        H = self._num_heads
        D = self._units // H
        q = self.query(x).reshape(B, T, H, D).permute(0, 2, 1, 3)
        k = self.key(x).reshape(B, T, H, D).permute(0, 2, 1, 3)
        v = self.value(x).reshape(B, T, H, D).permute(0, 2, 1, 3)
        out = self._attend(q, k, v, mask, B, T, D)          # (B, H, T, D)
        out = out.permute(0, 2, 1, 3).reshape(B, T, self._units)
        return self.proj(out)

    def _attend(self, q, k, v, mask, B, T, D):
        if use_flash(T, self.dropout.p):
            return flash_attention(q, k, v, scale=1.0 / math.sqrt(D),
                                   kv_mask=mask)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
        if mask is not None:
            scores = scores + (1.0 - mask.reshape(B, 1, 1, T)) * -1e30
        attn = self.dropout(softmax(scores, axis=-1))
        return torch.matmul(attn, v)


class PositionwiseFFN(nn.Module):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 device=None):
        super().__init__()
        self.ffn_1 = Dense(units, hidden_size, device=device)
        self.ffn_2 = Dense(hidden_size, units, device=device)
        self.dropout = nn.Dropout(dropout)
        self._activation = activation

    def forward(self, x):
        h = self.ffn_1(x)
        h = (leaky_relu(h, act_type="gelu") if self._activation == "gelu"
             else activation(h, act_type=self._activation))
        return self.dropout(self.ffn_2(h))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            device=device)
        self.ln1 = LayerNorm(units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, device=device)
        self.ln2 = LayerNorm(units, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        h = self.ln1(x + self.dropout(self.attention(x, mask)))
        return self.ln2(h + self.ffn(h))


class BERTEncoder(nn.Module):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(units, hidden_size, num_heads, dropout,
                                    device=device)
            for _ in range(num_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


def _reset(named_params, device, seed):
    """N(0, 0.02) weights, gamma 1, biases and beta 0, from a generator
    seeded with ``seed`` on ``device``, in the order given."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for name, p in named_params:
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                p.normal_(0.0, 0.02, generator=gen)
            elif leaf == "gamma":
                p.fill_(1.0)
            else:
                p.zero_()


def _load(model, state):
    """Copy ``state`` (name -> tensor on the model's device) into
    ``model``; the key sets and every shape must match."""
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise KeyError(
            "parameter sets differ: missing %s, extra %s"
            % (sorted(set(own) - set(state))[:8],
               sorted(set(state) - set(own))[:8]))
    with torch.no_grad():
        for name, p in own.items():
            if state[name].shape != p.shape:
                raise ValueError("%s: shape %s, model has %s"
                                 % (name, tuple(state[name].shape),
                                    tuple(p.shape)))
            p.copy_(state[name])
    return model


class BERTModel(nn.Module):
    """Token + segment + position embeddings -> encoder -> (sequence,
    pooled).

    ``device=None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain path. Weights are drawn from N(0, 0.02)
    (biases and beta 0, gamma 1) with a ``torch.Generator`` seeded from
    ``seed`` on that device; ``load_params`` replaces them."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab=2, dropout=0.1, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self._units = units
        self.config = dict(vocab_size=vocab_size, units=units,
                           hidden_size=hidden_size, num_layers=num_layers,
                           num_heads=num_heads, max_length=max_length,
                           token_type_vocab=token_type_vocab)
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.token_type_embed = Embedding(token_type_vocab, units,
                                          device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_ln = LayerNorm(units, device=device)
        self.embed_dropout = nn.Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, device=device)
        self.pooler = Dense(units, units, activation="tanh", device=device)
        self.reset_parameters(seed)
        self.eval()

    @property
    def device(self):
        return self.word_embed.weight.device

    def reset_parameters(self, seed=0):
        _reset(self.named_parameters(), self.device, seed)

    def load_params(self, params):
        """Copy a JAX-named parameter dict (numpy arrays, tensors or the
        JAX package's NDArrays) into this model; every key and shape must
        match."""
        return _load(self, params_from_jax(params, self.device))

    def forward(self, token_ids, token_types=None, valid_mask=None):
        B, T = token_ids.shape[0], token_ids.shape[-1]
        positions = torch.arange(T, device=token_ids.device)
        x = self.word_embed(token_ids)
        x = x + self.position_embed(positions)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_dropout(self.embed_ln(x))
        seq = self.encoder(x, valid_mask)
        pooled = self.pooler(seq[:, 0].reshape(B, self._units))
        return seq, pooled


class BERTForPretrain(nn.Module):
    """MLM + NSP heads over a ``BERTModel`` (the benchmarked training
    configuration of the JAX package).

    ``mlm_dense`` (tanh) -> ``mlm_ln`` -> ``mlm_decoder`` (vocab logits)
    over the sequence output, and ``nsp`` (2 logits) over the pooled
    output. With ``tie_decoder=True`` the decoder's weight is the word
    embedding's one ``nn.Parameter`` (listed once by ``named_parameters``,
    so an optimizer updates it once). When ``mlm_positions`` (B, M) is given
    (keyword-only) the masked positions' hidden states are gathered first,
    so the vocab projection runs on those rows only; without it the logits
    cover every position.

    ``device=None`` is ``cuda:0`` and raises without CUDA; a given ``bert``
    must lie on that device. Without ``bert`` a ``BERTModel(vocab_size)`` is
    built there. The heads are drawn as ``BERTModel``'s weights are, from
    ``seed``."""

    def __init__(self, bert=None, vocab_size=30522, tie_decoder=False,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        if bert is None:
            bert = BERTModel(vocab_size=vocab_size, device=device, seed=seed)
        elif bert.device != device:
            raise ValueError("BERTForPretrain: bert is on %s, not %s"
                             % (bert.device, device))
        units = bert._units
        self.bert = bert
        self.mlm_dense = Dense(units, units, activation="tanh", device=device)
        self.mlm_ln = LayerNorm(units, device=device)
        self.mlm_decoder = Dense(units, vocab_size, device=device)
        self.nsp = Dense(units, 2, device=device)
        self.tie_decoder = bool(tie_decoder)
        if self.tie_decoder:
            if tuple(bert.word_embed.weight.shape) != (vocab_size, units):
                raise ValueError("tie_decoder: the word embedding is %s, the "
                                 "decoder needs (%d, %d)"
                                 % (tuple(bert.word_embed.weight.shape),
                                    vocab_size, units))
            self.mlm_decoder.weight = bert.word_embed.weight
        # a tied decoder weight is listed once, as bert.word_embed.weight
        _reset([(n, p) for n, p in self.named_parameters()
                if not n.startswith("bert.")], device, seed + 1)
        self.eval()

    @property
    def device(self):
        return self.bert.device

    def load_params(self, params):
        """Copy a JAX-named pretraining parameter dict into this model (see
        ``pretrain_params_from_jax``)."""
        return _load(self, pretrain_params_from_jax(params, self.device,
                                                    self.tie_decoder))

    def forward(self, token_ids, token_types=None, valid_mask=None, *,
                mlm_positions=None):
        seq, pooled = self.bert(token_ids, token_types, valid_mask)
        if mlm_positions is not None:
            idx = mlm_positions.long()[:, :, None].expand(
                -1, -1, seq.shape[-1])
            seq = torch.gather(seq, 1, idx)             # (B, M, units)
        mlm = self.mlm_decoder(self.mlm_ln(self.mlm_dense(seq)))
        return mlm, self.nsp(pooled)


def bert_base(vocab_size=30522, dropout=0.1, **kwargs):
    cfg = dict(vocab_size=vocab_size, units=768, hidden_size=3072,
               num_layers=12, num_heads=12, dropout=dropout)
    cfg.update(kwargs)
    return BERTModel(**cfg)


def bert_large(vocab_size=30522, dropout=0.1, **kwargs):
    cfg = dict(vocab_size=vocab_size, units=1024, hidden_size=4096,
               num_layers=24, num_heads=16, dropout=dropout)
    cfg.update(kwargs)
    return BERTModel(**cfg)


def bert_param_shapes(vocab_size, units, hidden_size, num_layers,
                      max_length=512, token_type_vocab=2):
    """{JAX parameter name: shape} of a BERTModel."""
    shapes = {"word_embed.weight": (vocab_size, units),
              "token_type_embed.weight": (token_type_vocab, units),
              "position_embed.weight": (max_length, units),
              "embed_ln.gamma": (units,), "embed_ln.beta": (units,)}
    for i in range(num_layers):
        p = "encoder.layers.%d." % i
        for n in ("query", "key", "value", "proj"):
            shapes[p + "attention.%s.weight" % n] = (units, units)
            shapes[p + "attention.%s.bias" % n] = (units,)
        for ln in ("ln1", "ln2"):
            shapes[p + ln + ".gamma"] = (units,)
            shapes[p + ln + ".beta"] = (units,)
        shapes[p + "ffn.ffn_1.weight"] = (hidden_size, units)
        shapes[p + "ffn.ffn_1.bias"] = (hidden_size,)
        shapes[p + "ffn.ffn_2.weight"] = (units, hidden_size)
        shapes[p + "ffn.ffn_2.bias"] = (units,)
    shapes["pooler.weight"] = (units, units)
    shapes["pooler.bias"] = (units,)
    return shapes


def _to_tensor(v):
    """A tensor of ``v`` (a tensor, an array or the JAX package's NDArray)
    in its own dtype. A bfloat16 numpy array (ml_dtypes' type, which numpy
    does not know by itself) is recognised by its dtype's name and size and
    carried over bit for bit, without importing ml_dtypes."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if hasattr(v, "asnumpy"):           # the JAX package's NDArray
        v = v.asnumpy()
    a = np.array(v)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(params, device):
    """Carry a BERT parameter dict named as the JAX package names it onto
    ``device`` as float32 tensors. The configuration is read from the
    shapes; the key set must be exactly that configuration's and every
    shape must match, else KeyError / ValueError."""
    tensors = {str(k): _to_tensor(v) for k, v in params.items()}
    anchors = ("word_embed.weight", "token_type_embed.weight",
               "position_embed.weight")
    absent = [a for a in anchors if a not in tensors]
    if absent:
        raise KeyError("not a BERT parameter set: missing %s" % absent)
    vocab_size, units = tensors["word_embed.weight"].shape
    layer_ids = {int(k.split(".")[2]) for k in tensors
                 if k.startswith("encoder.layers.")
                 and k.split(".")[2].isdigit()}
    num_layers = max(layer_ids) + 1 if layer_ids else 0
    ffn1 = tensors.get("encoder.layers.0.ffn.ffn_1.weight")
    hidden = ffn1.shape[0] if ffn1 is not None else 0
    expected = bert_param_shapes(
        vocab_size, units, hidden, num_layers,
        max_length=tensors["position_embed.weight"].shape[0],
        token_type_vocab=tensors["token_type_embed.weight"].shape[0])
    missing = sorted(set(expected) - set(tensors))
    extra = sorted(set(tensors) - set(expected))
    if missing or extra:
        raise KeyError("BERT parameter names do not match: missing %s, "
                       "extra %s" % (missing[:8], extra[:8]))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError("%s: shape %s, expected %s"
                             % (name, tuple(tensors[name].shape), shape))
    return {name: t.to(device=device, dtype=torch.float32)
            for name, t in tensors.items()}


def _head_shapes(vocab_size, units, tie_decoder):
    shapes = {"mlm_dense.weight": (units, units), "mlm_dense.bias": (units,),
              "mlm_ln.gamma": (units,), "mlm_ln.beta": (units,),
              "mlm_decoder.bias": (vocab_size,),
              "nsp.weight": (2, units), "nsp.bias": (2,)}
    if not tie_decoder:
        shapes["mlm_decoder.weight"] = (vocab_size, units)
    return shapes


def pretrain_param_shapes(vocab_size, units, hidden_size, num_layers,
                          max_length=512, token_type_vocab=2,
                          tie_decoder=False):
    """{JAX parameter name: shape} of a BERTForPretrain's distinct
    parameters: the encoder's under ``bert.`` and the heads'. A tied
    decoder's weight is ``bert.word_embed.weight`` and is not listed again
    as ``mlm_decoder.weight``."""
    shapes = {"bert." + k: v for k, v in bert_param_shapes(
        vocab_size, units, hidden_size, num_layers, max_length,
        token_type_vocab).items()}
    shapes.update(_head_shapes(vocab_size, units, tie_decoder))
    return shapes


def pretrain_params_from_jax(params, device, tie_decoder):
    """Carry a BERTForPretrain parameter dict named as the JAX package's
    ``_collect_params_with_prefix()`` names it onto ``device`` as float32
    tensors. With ``tie_decoder`` the JAX dict also lists the shared matrix
    as ``mlm_decoder.weight``; it is accepted only if it equals
    ``bert.word_embed.weight``, and dropped. The key set must be exactly the
    configuration's and every shape must match, else KeyError /
    ValueError."""
    tensors = {str(k): _to_tensor(v) for k, v in params.items()}
    if tie_decoder and "mlm_decoder.weight" in tensors:
        dec = tensors.pop("mlm_decoder.weight")
        emb = tensors.get("bert.word_embed.weight")
        if emb is None or dec.shape != emb.shape or not torch.equal(dec, emb):
            raise ValueError("tie_decoder: mlm_decoder.weight is not "
                             "bert.word_embed.weight; a tied decoder's "
                             "weight is the word embedding")
    out = {"bert." + k: v for k, v in params_from_jax(
        {k[len("bert."):]: v for k, v in tensors.items()
         if k.startswith("bert.")}, device).items()}
    vocab_size, units = out["bert.word_embed.weight"].shape
    bias = tensors.get("mlm_decoder.bias")
    expected = _head_shapes(bias.shape[0] if bias is not None else vocab_size,
                            units, tie_decoder)
    heads = {k: v for k, v in tensors.items() if not k.startswith("bert.")}
    missing = sorted(set(expected) - set(heads))
    extra = sorted(set(heads) - set(expected))
    if missing or extra:
        raise KeyError("BERTForPretrain parameter names do not match: "
                       "missing %s, extra %s" % (missing[:8], extra[:8]))
    for name, t in heads.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError("%s: shape %s, expected %s"
                             % (name, tuple(t.shape), expected[name]))
        out[name] = t.to(device=device, dtype=torch.float32)
    return out
