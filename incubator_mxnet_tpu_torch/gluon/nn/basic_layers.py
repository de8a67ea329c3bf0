"""Gluon's basic layers on the port's HybridBlock and Parameter.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py`` for the
layers of the ResNet and word-LM paths: ``HybridSequential``, ``Dense``,
``BatchNorm``, ``Activation``, ``Dropout``, ``Embedding`` and ``Flatten``,
with gluon's
constructor arguments, defaults, initializers and deferred shape inference
(``in_units`` / ``in_channels`` 0 are completed from the first input).
Parameter names are gluon's (``weight``, ``bias``, ``gamma``, ``beta``;
BatchNorm's ``running_mean`` and ``running_var`` are auxiliary state, torch
buffers), and a ``HybridSequential`` names its children ``"0"``, ``"1"``,
..., so ``named_parameters()`` and ``named_buffers()`` of a model give the
JAX package's ``_collect_params_with_prefix()`` keys.

BatchNorm normalizes with the batch statistics when
``autograd.is_training()`` (inside ``autograd.record()`` or
``train_mode()``) and not ``use_global_stats``, and then writes the moved
statistics into its running-statistic tensors in place, as gluon does
outside a trace. ``init_params`` draws gluon's usual start
(``mx.init.Xavier()``'s form) from a seeded ``torch.Generator`` for nets
whose shapes are known. ``Dense(..., params=other.params)`` shares
``other``'s weight of the same name (a tied decoder). Sequential, LayerNorm,
InstanceNorm and the Lambda blocks wait for ROADMAP Queue 1 items 6 and 10.
"""

import math

import torch

from ... import autograd as _ag
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation",
           "Dropout", "Embedding", "Flatten", "init_params"]


def _xavier_(w, gen):
    """``mx.init.Xavier()``: uniform in +-sqrt(3 / ((fan_in + fan_out) /
    2)), fans counted over the receptive field (initializer.py)."""
    rf = math.prod(w.shape[2:]) if w.dim() > 2 else 1
    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    scale = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    w.uniform_(-scale, scale, generator=gen)


def init_params(block, seed=0):
    """Gluon's usual start, in ``named_parameters()`` order: Xavier weights
    from a ``torch.Generator`` seeded with ``seed`` on the block's device,
    gamma and running_var 1, biases, beta and running_mean 0. Returns the
    block."""
    tensors = list(block.named_parameters()) + list(block.named_buffers())
    if not tensors:
        return block
    gen = torch.Generator(device=tensors[0][1].device).manual_seed(int(seed))
    with torch.no_grad():
        for name, t in tensors:
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                _xavier_(t, gen)
            elif leaf in ("gamma", "running_var"):
                t.fill_(1.0)
            else:
                t.zero_()
    return block


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks, run in order; children are named "0", "1",
    ..."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = []
            if isinstance(x, (tuple, list)):
                args = x[1:]
                x = x[0]
        if args:
            return tuple([x] + list(args))
        return x

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer: y = act(x W^T + b) (reference: Dense)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          dtype=dtype,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
                                            init=_init_of(bias_initializer),
                                            dtype=dtype,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hook(self, x, *args):
        in_units = x.shape[-1] if not self._flatten \
            else int(math.prod(x.shape[1:]))
        self.weight.shape_inferred((self._units, in_units))
        if self.bias is not None:
            self.bias.shape_inferred((self._units,))
        for p in (self.weight, self.bias):
            if p is not None and p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape and len(shape) > 1 else None,
            shape[0] if shape else None, self._act_type or "linear")


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation  # before super(): _alias() uses it
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics as auxiliary state
    (reference: BatchNorm)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=_init_of(gamma_initializer),
                                         allow_deferred_init=True,
                                         differentiable=scale)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=_init_of(beta_initializer),
                                        allow_deferred_init=True,
                                        differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=_init_of(running_mean_initializer),
                allow_deferred_init=True, differentiable=False, aux=True)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=_init_of(running_variance_initializer),
                allow_deferred_init=True, differentiable=False, aux=True)

    def _shape_hook(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape_inferred((c,))
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def cast(self, dtype):
        if dtype in ("float16", "bfloat16"):
            dtype = "float32"  # keep BN stats in fp32 (reference does too)
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = _ag.is_training() and not self._use_global_stats
        out, new_mean, new_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            with torch.no_grad():
                for p, new in ((self.running_mean, new_mean),
                               (self.running_var, new_var)):
                    p.data()._t.copy_(getattr(new, "_t", new))
        return out

    def __repr__(self):
        return "BatchNorm(axis=%s, momentum=%s, eps=%s, in_channels=%s)" % (
            self._axis, self._momentum, self._epsilon,
            self.gamma.shape[0] if self.gamma.shape else None)


class Dropout(HybridBlock):
    """Identity outside training and at rate 0; dropping while training is
    random and waits for the Dropout op (ROADMAP Queue 1 item 5)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0 or not _ag.is_training():
            return x
        raise NotImplementedError("Dropout(%s) while training: the random "
                                  "Dropout op is not ported yet (ROADMAP "
                                  "Queue 1 item 5)" % self._rate)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


class Embedding(HybridBlock):
    """Rows of a (input_dim, output_dim) weight at integer ids (reference:
    Embedding); ids outside [0, input_dim) raise ValueError. The gradient
    is dense; ``sparse_grad`` waits for ROADMAP Queue 1 item 4."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise NotImplementedError("Embedding(sparse_grad=True): sparse "
                                      "gradients are not ported yet (ROADMAP "
                                      "Queue 1 item 4)")
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return "Embedding(%d -> %d)" % (self._input_dim, self._output_dim)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


def _init_of(name_or_init):
    if name_or_init is None or not isinstance(name_or_init, str):
        return name_or_init
    from ... import initializer as _init
    return _init.create(name_or_init)
