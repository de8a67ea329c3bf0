"""ResNet v1 / v2 families as ``torch.nn.Module``s.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
one generic residual unit driven by a conv-plan table (``_conv_plan``,
``_ResidualUnit``, v1 and v2 orderings) and one assembler (``_ResNet``),
with ``ResNetV1``/``ResNetV2``, the ``BasicBlock``/``Bottleneck`` shells,
``resnet_spec``, ``get_resnet`` and ``resnet{18,34,50,101,152}_v{1,2}``.
Parameter and buffer names are the JAX net's
``_collect_params_with_prefix()`` keys (``features.0.weight``,
``features.1.gamma``, ..., ``output.bias``), so JAX weights and running
statistics come across by name with ``params_from_jax``. v1 bottlenecks
keep the reference's biased 1x1 convs: ResNet-50 v1 trains 25,575,912
elements in 193 tensors.

Differences from the JAX package: every layer is given its ``in_channels``
(3 for the RGB stem; deferred shape inference is ROADMAP Queue 1 item 3),
and per-stage rematerialization (``remat_stages``, ``MXTPU_RESNET_REMAT``)
is Queue 1 item 6 and raises. A model is built on ``device`` (None is
``cuda:0`` and raises without CUDA; ``device="cpu"`` for the plain path),
starts from ``init_params(seed)`` (Xavier weights), and is in inference
mode (``eval()``), as the JAX net's forward outside ``autograd.record()``.
"""

import os

import numpy as np
import torch
from torch import nn as tnn

from ....context import resolve_device
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D, init_params)

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet", "resnet_spec", "params_from_jax"]


def _no_remat(what):
    return NotImplementedError("%s: per-stage rematerialization is not "
                               "ported yet (ROADMAP Queue 1 item 6)" % what)


def _conv_plan(kind, channels, stride, preact):
    """(out_channels, kernel, stride, pad, bias) per conv of one residual
    unit. v1 bottlenecks stride on the first 1x1 (and carry the reference's
    quirk of BIASED 1x1 convs); v2 strides on the 3x3, all convs bias-free."""
    if kind == "basic":
        return [(channels, 3, stride, 1, False), (channels, 3, 1, 1, False)]
    mid = channels // 4
    if preact:
        return [(mid, 1, 1, 0, False), (mid, 3, stride, 1, False),
                (channels, 1, 1, 0, False)]
    return [(mid, 1, stride, 0, True), (mid, 3, 1, 1, False),
            (channels, 1, 1, 0, True)]


class _ResidualUnit(tnn.Module):
    """One residual unit. ``preact=False`` is the v1 ordering
    (conv-BN-relu ... + identity, relu after the add); ``preact=True`` is
    the v2 ordering (BN-relu-conv ..., identity added raw, and the
    downsample path branches from the ACTIVATED input)."""

    def __init__(self, kind, channels, stride, downsample=False,
                 in_channels=0, preact=False, remat=False,
                 remat_policy="full", prefix=None, device=None):
        super().__init__()
        if remat:
            raise _no_remat("_ResidualUnit(remat=True)")
        if not in_channels:
            raise NotImplementedError(
                "_ResidualUnit without in_channels (deferred shape "
                "inference) is not ported yet (ROADMAP Queue 1 item 3)")
        device = resolve_device(device)
        self._preact = preact
        self.body = HybridSequential()
        c_in = in_channels
        plan = _conv_plan(kind, channels, stride, preact)
        for i, (c, k, s, p, bias) in enumerate(plan):
            if preact:
                self.body.add(BatchNorm(in_channels=c_in, device=device),
                              Activation("relu"))
            self.body.add(Conv2D(c, kernel_size=k, strides=s, padding=p,
                                 use_bias=bias, in_channels=c_in,
                                 device=device))
            if not preact:
                self.body.add(BatchNorm(in_channels=c, device=device))
                if i < len(plan) - 1:
                    self.body.add(Activation("relu"))
            c_in = c
        if not downsample:
            self.downsample = None
        elif preact:
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, device=device)
        else:
            self.downsample = HybridSequential()
            self.downsample.add(
                Conv2D(channels, 1, stride, use_bias=False,
                       in_channels=in_channels, device=device),
                BatchNorm(in_channels=channels, device=device))

    def forward(self, x):
        if self._preact:
            # v2: the first BN-relu of the body also feeds the shortcut
            cells = list(self.body)
            pre = cells[1](cells[0](x))
            shortcut = self.downsample(pre) if self.downsample is not None \
                else x
            out = pre
            for layer in cells[2:]:
                out = layer(out)
            return out + shortcut
        shortcut = self.downsample(x) if self.downsample is not None else x
        return torch.relu(self.body(x) + shortcut)


def _unit_cls(name, kind, preact):
    """API-parity shells: BasicBlockV1(channels, stride, downsample, ...)"""
    class _Unit(_ResidualUnit):
        def __init__(self, channels, stride, downsample=False, in_channels=0,
                     **kwargs):
            super().__init__(kind, channels, stride, downsample, in_channels,
                             preact, **kwargs)
    _Unit.__name__ = _Unit.__qualname__ = name
    return _Unit


BasicBlockV1 = _unit_cls("BasicBlockV1", "basic", False)
BottleneckV1 = _unit_cls("BottleneckV1", "bottleneck", False)
BasicBlockV2 = _unit_cls("BasicBlockV2", "basic", True)
BottleneckV2 = _unit_cls("BottleneckV2", "bottleneck", True)


class _ResNet(tnn.Module):
    """Assembler: stem -> stages of residual units -> pool -> classifier.

    v2 (preact) wraps the stages with the reference's extra input BN
    (scale/center off) and a final BN-relu before pooling."""

    def __init__(self, kind, layers, channels, preact, classes=1000,
                 thumbnail=False, unit_factory=None, remat_stages=None,
                 remat_policy=None, prefix=None, device=None, seed=0):
        super().__init__()
        assert len(layers) == len(channels) - 1
        if remat_stages is None:
            env = os.environ.get("MXTPU_RESNET_REMAT", "")
            remat_stages = {s.strip() for s in env.split(",") if s.strip()}
        if remat_stages:
            raise _no_remat("remat_stages=%s" % sorted(remat_stages))
        device = resolve_device(device)
        self._preact = preact
        if unit_factory is None:
            def unit_factory(out_c, stride, downsample, in_c):
                return _ResidualUnit(kind, out_c, stride, downsample,
                                     in_channels=in_c, preact=preact,
                                     device=device)
        self.features = HybridSequential()
        if preact:
            self.features.add(BatchNorm(scale=False, center=False,
                                        in_channels=3, device=device))
        if thumbnail:
            self.features.add(Conv2D(channels[0], 3, 1, 1, use_bias=False,
                                     in_channels=3, device=device))
        else:
            self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                     in_channels=3, device=device),
                              BatchNorm(in_channels=channels[0],
                                        device=device),
                              Activation("relu"), MaxPool2D(3, 2, 1))
        in_c = channels[0]
        for i, (n_units, out_c) in enumerate(zip(layers, channels[1:])):
            stage = HybridSequential()
            for j in range(n_units):
                stride = 2 if (i > 0 and j == 0) else 1
                stage.add(unit_factory(out_c, stride,
                                       j == 0 and out_c != in_c, in_c))
                in_c = out_c
            self.features.add(stage)
        if preact:
            self.features.add(BatchNorm(in_channels=in_c, device=device),
                              Activation("relu"))
        self.features.add(GlobalAvgPool2D())
        if preact:
            self.features.add(Flatten())
        self.output = Dense(classes, in_units=channels[-1], device=device)
        self.device = device
        init_params(self, seed)
        self.eval()

    def forward(self, x):
        return self.output(self.features(x))


def _block_factory(block, device):
    """ResNetV1/V2 instantiate the block class the caller passes."""
    def make(out_c, stride, downsample, in_c):
        return block(out_c, stride, downsample, in_channels=in_c,
                     device=device)
    return make


class ResNetV1(_ResNet):
    def __init__(self, block, layers, channels, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__("custom", layers, channels, preact=False,
                         unit_factory=_block_factory(block, device),
                         device=device, **kwargs)


class ResNetV2(_ResNet):
    def __init__(self, block, layers, channels, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__("custom", layers, channels, preact=True,
                         unit_factory=_block_factory(block, device),
                         device=device, **kwargs)


# depth -> (unit kind, units per stage, channels incl. stem)
resnet_spec = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottleneck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottleneck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottleneck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ResNet-``num_layers`` v``version`` from ``resnet_spec``; ``ctx`` and
    ``root`` are accepted and not read, as in the JAX package (``device``
    places the model)."""
    if num_layers not in resnet_spec:
        raise ValueError("no resnet spec for depth %r" % (num_layers,))
    if version not in (1, 2):
        raise ValueError("resnet version must be 1 or 2")
    if pretrained:
        raise RuntimeError("pretrained weights unavailable in this "
                           "zero-egress environment; load_parameters manually")
    kind, layers, channels = resnet_spec[num_layers]
    return _ResNet(kind, layers, channels, preact=(version == 2), **kwargs)


def _variant(version, depth):
    def build(**kwargs):
        return get_resnet(version, depth, **kwargs)
    build.__name__ = "resnet%d_v%d" % (depth, version)
    build.__doc__ = "ResNet-%d v%d from the resnet_spec table." % (depth,
                                                                   version)
    return build


resnet18_v1 = _variant(1, 18)
resnet34_v1 = _variant(1, 34)
resnet50_v1 = _variant(1, 50)
resnet101_v1 = _variant(1, 101)
resnet152_v1 = _variant(1, 152)
resnet18_v2 = _variant(2, 18)
resnet34_v2 = _variant(2, 34)
resnet50_v2 = _variant(2, 50)
resnet101_v2 = _variant(2, 101)
resnet152_v2 = _variant(2, 152)


def _to_tensor(v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    if hasattr(v, "asnumpy"):           # the JAX package's NDArray
        v = v.asnumpy()
    return torch.from_numpy(np.array(v))


def params_from_jax(params, net):
    """Fill ``net``'s parameters and running statistics from ``params``, a
    {name: array} dict named as the JAX net's
    ``_collect_params_with_prefix()`` (numpy arrays, tensors or the JAX
    package's NDArrays). Every name and shape is checked both ways
    (KeyError, ValueError). Returns ``net``."""
    own = dict(net.named_parameters())
    own.update(net.named_buffers())
    tensors = {str(k): _to_tensor(v) for k, v in params.items()}
    missing = sorted(set(own) - set(tensors))
    extra = sorted(set(tensors) - set(own))
    if missing or extra:
        raise KeyError("parameter names do not match: missing %s, extra %s"
                       % (missing[:8], extra[:8]))
    for name, t in tensors.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError("%s: shape %s, the net has %s"
                             % (name, tuple(t.shape),
                                tuple(own[name].shape)))
    with torch.no_grad():
        for name, t in tensors.items():
            own[name].copy_(t.to(own[name].dtype))
    return net
