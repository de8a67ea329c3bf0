"""Gluon's 2-D convolution and pooling layers as ``torch.nn.Module``s.

Counterpart of ``incubator_mxnet_tpu/gluon/nn/conv_layers.py`` for the
ResNet path: Conv2D (weight ``(channels, in_channels / groups, kh, kw)``,
bias ``(channels,)``), MaxPool2D, AvgPool2D and GlobalAvgPool2D, with
gluon's constructor arguments and defaults, NCHW. ``layout`` is accepted
and not read, as in the JAX package. ``in_channels`` must be given
(deferred shape inference is ROADMAP Queue 1 item 3); ``ceil_mode=True``
raises at the call (Queue 1 item 9). The 1-D and 3-D layers, the global
max pools, the transposed convolutions and ReflectionPad2D wait for the
rest of the op surface (item 9).
"""

from torch import nn

from ...context import resolve_device
from ...ops.nn import activation, convolution, pooling
from .basic_layers import _default_init, _param, _require

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(nn.Module):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 prefix=None, device=None):
        super().__init__()
        _default_init("Conv2D",
                      weight_initializer=(weight_initializer, None),
                      bias_initializer=(bias_initializer, "zeros"))
        in_channels = _require("Conv2D", "in_channels", in_channels)
        device = resolve_device(device)
        kernel_size = _pair(kernel_size)
        self._kwargs = {"kernel": kernel_size, "stride": _pair(strides),
                        "dilate": _pair(dilation), "pad": _pair(padding),
                        "num_filter": channels, "num_group": groups}
        self._act_type = activation
        self.weight = _param((channels, in_channels // groups) + kernel_size,
                             device)
        self.bias = _param((channels,), device) if use_bias else None

    def forward(self, x):
        out = convolution(x, self.weight, self.bias,
                          no_bias=self.bias is None, **self._kwargs)
        return activation(out, self._act_type) if self._act_type else out


class _Pooling(nn.Module):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None):
        super().__init__()
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, prefix=None):
        super().__init__(_pair(pool_size), strides and _pair(strides),
                         _pair(padding), ceil_mode, False, "max")


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 prefix=None):
        super().__init__(_pair(pool_size), strides and _pair(strides),
                         _pair(padding), ceil_mode, False, "avg",
                         count_include_pad)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None):
        super().__init__((1, 1), None, (0, 0), True, True, "avg")
