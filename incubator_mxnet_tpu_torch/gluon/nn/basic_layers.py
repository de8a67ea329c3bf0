"""Gluon's basic layers as ``torch.nn.Module``s.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``:
``HybridSequential``, ``Dense``, ``BatchNorm``, ``Activation`` and
``Flatten``, with gluon's constructor arguments and defaults. Parameter
names are gluon's (``weight``, ``bias``, ``gamma``, ``beta``; BatchNorm's
``running_mean`` and ``running_var`` are buffers) and a ``HybridSequential``
names its children ``"0"``, ``"1"``, ..., so ``named_parameters()`` and
``named_buffers()`` of a model give the JAX package's
``_collect_params_with_prefix()`` keys.

What gluon's block core does and this slice does not, raising
NotImplementedError that names its ROADMAP item: deferred shape inference
(``in_units`` / ``in_channels`` must be given) and initializers other than
the defaults (Queue 1 item 3), parameter sharing through ``params=``, and
dtypes other than float32 (item 5). Layers with parameters take
``device`` (None is ``cuda:0`` and raises without CUDA). ``init_params``
draws gluon's usual start, ``mx.init.Xavier()`` weights and the layers'
default constants, from a seeded ``torch.Generator``.
"""

import math

import torch
from torch import nn

from ...context import resolve_device
from ...ops.nn import activation, batch_norm, flatten, fully_connected

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation", "Flatten",
           "init_params"]


def _not_yet(what, item):
    return NotImplementedError("%s is not ported yet (ROADMAP Queue 1 %s)"
                               % (what, item))


def _require(layer, what, value):
    """Deferred shape inference is not ported: ``value`` must be given."""
    if not value:
        raise _not_yet("%s without %s (deferred shape inference)"
                       % (layer, what), "item 3")
    return int(value)


def _default_init(layer, **given):
    """Initializer arguments other than gluon's defaults are not ported."""
    for name, (value, default) in given.items():
        if value != default:
            raise _not_yet("%s(%s=%r): initializers" % (layer, name, value),
                           "item 3")


def _check_float32(layer, dtype):
    if str(dtype).replace("torch.", "") != "float32":
        raise _not_yet("%s(dtype=%r)" % (layer, dtype), "item 5")


def _param(shape, device, fill=0.0, requires_grad=True):
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32,
                                   device=device),
                        requires_grad=requires_grad)


def _xavier_(w, gen):
    """``mx.init.Xavier()``: uniform in +-sqrt(3 / ((fan_in + fan_out) /
    2)), fans counted over the receptive field (initializer.py:193-209)."""
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


class HybridSequential(nn.Sequential):
    """Stack of layers run in order; children are named "0", "1", ...
    ``prefix`` is accepted for gluon's signature: names are structural."""

    def __init__(self, prefix=None, params=None):
        if params is not None:
            raise _not_yet("HybridSequential(params=...): parameter sharing",
                           "item 3")
        super().__init__()

    def add(self, *blocks):
        for block in blocks:
            self.append(block)


class Dense(nn.Module):
    """y = act(x W^T + b), weight (units, in_units); ``flatten`` folds every
    axis after the first into the input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 device=None):
        super().__init__()
        _check_float32("Dense", dtype)
        _default_init("Dense", weight_initializer=(weight_initializer, None),
                      bias_initializer=(bias_initializer, "zeros"))
        in_units = _require("Dense", "in_units", in_units)
        device = resolve_device(device)
        self._units, self._flatten, self._act_type = units, flatten, \
            activation
        self.weight = _param((units, in_units), device)
        self.bias = _param((units,), device) if use_bias else None

    def forward(self, x):
        out = fully_connected(x, self.weight, self.bias,
                              no_bias=self.bias is None,
                              flatten=self._flatten)
        return activation(out, self._act_type) if self._act_type else out


class BatchNorm(nn.Module):
    """Batch normalization over ``axis`` with moving statistics as buffers.
    In training mode (``train()``, and not ``use_global_stats``) it
    normalizes with the batch statistics and writes the moved statistics
    into its buffers under ``torch.no_grad()``, as gluon does outside a
    trace; otherwise it uses the moving ones. ``scale=False`` /
    ``center=False`` hold gamma / beta as tensors that take no gradient
    (gluon's ``differentiable=False``), and gamma then acts as ones."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, device=None):
        super().__init__()
        _default_init(
            "BatchNorm", beta_initializer=(beta_initializer, "zeros"),
            gamma_initializer=(gamma_initializer, "ones"),
            running_mean_initializer=(running_mean_initializer, "zeros"),
            running_variance_initializer=(running_variance_initializer,
                                          "ones"))
        c = _require("BatchNorm", "in_channels", in_channels)
        device = resolve_device(device)
        self._axis, self._momentum, self._epsilon = axis, momentum, epsilon
        self._scale, self._use_global_stats = scale, use_global_stats
        self.gamma = _param((c,), device, 1.0, requires_grad=scale)
        self.beta = _param((c,), device, 0.0, requires_grad=center)
        self.register_buffer("running_mean",
                             torch.zeros(c, dtype=torch.float32,
                                         device=device))
        self.register_buffer("running_var",
                             torch.ones(c, dtype=torch.float32,
                                        device=device))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        out, new_mean, new_var = batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return out


class Activation(nn.Module):
    """relu / sigmoid / tanh by name."""

    def __init__(self, activation, prefix=None):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return activation(x, self._act_type)


class Flatten(nn.Module):
    """(N, ...) -> (N, prod(...))."""

    def __init__(self, prefix=None):
        super().__init__()

    def forward(self, x):
        return flatten(x)
