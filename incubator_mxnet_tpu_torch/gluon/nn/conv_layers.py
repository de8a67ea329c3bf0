"""Gluon's convolution and pooling layers on the port's HybridBlock.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/conv_layers.py`` for the
ResNet path: Conv2D (weight ``(channels, in_channels / groups, kh, kw)``,
bias ``(channels,)``, ``in_channels`` 0 completed from the first input),
MaxPool2D, AvgPool2D and GlobalAvgPool2D, with gluon's constructor
arguments and defaults, NCHW. ``layout`` is accepted and not read, as in the
JAX package. ``ceil_mode=True`` raises at the call. The 1-D and 3-D layers,
the global max pools, the transposed convolutions and ReflectionPad2D wait
for the rest of the op surface (ROADMAP Queue 1 item 10).
"""

from ..block import HybridBlock
from .basic_layers import _init_of

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups}
        self._act_type = activation
        with self.name_scope():
            wshape = (channels, in_channels // groups if in_channels
                      else 0) + kernel_size
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=_init_of(bias_initializer),
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hook(self, x, *args):
        cin = x.shape[1]
        k = self._kwargs["kernel"]
        g = self._kwargs["num_group"]
        self.weight.shape_inferred((self._channels, cin // g) + tuple(k))
        if self.bias is not None:
            self.bias.shape_inferred((self._channels,))
        for p in (self.weight, self.bias):
            if p is not None and p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, no_bias=bias is None,
                            **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return "%s(channels=%s, kernel=%s)" % (
            type(self).__name__, self._channels, self._kwargs["kernel"])


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), strides and _tup(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "max", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), strides and _tup(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)
