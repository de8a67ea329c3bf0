"""ResNet v1 / v2 families on the port's HybridBlock.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
one generic residual unit driven by a conv-plan table (``_conv_plan``,
``_ResidualUnit``, v1 and v2 orderings) and one assembler (``_ResNet``),
with ``ResNetV1``/``ResNetV2``, the ``BasicBlock``/``Bottleneck`` shells,
``resnet_spec``, ``get_resnet`` and ``resnet{18,34,50,101,152}_v{1,2}``,
built as the JAX package builds them: the same layers, the same deferred
``in_channels``, the same names. So ``np.random.seed(s);
net.initialize(mx.init.Xavier(), ctx=...)`` and a first forward draw the
JAX net's weights, and parameter and buffer names are the JAX net's
``_collect_params_with_prefix()`` keys (``features.0.weight``,
``features.1.gamma``, ..., ``output.bias``). v1 bottlenecks keep the
reference's biased 1x1 convs: ResNet-50 v1 trains 25,575,912 elements in
193 tensors.

Built with ``device=...`` (a ``torch.device`` or its name), a model is
ready at once, as ``ShardedTrainer`` and ``params_from_jax`` take it: every
shape is inferred on that device and the weights start from
``init_params(seed)`` (Xavier's form from a seeded ``torch.Generator``;
numpy's global RNG is not touched). Without ``device`` it is a gluon net
whose parameters wait for ``initialize``. Per-stage rematerialization
(``remat_stages``, ``MXTPU_RESNET_REMAT``) is ROADMAP Queue 1 item 9 and
raises.
"""

import os

import numpy as np
import torch

from .... import initializer as _init
from ....context import resolve_device
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet", "resnet_spec", "params_from_jax"]


def _no_remat(what):
    return NotImplementedError("%s: per-stage rematerialization is not "
                               "ported yet (ROADMAP Queue 1 item 9)" % what)


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


class _ResidualUnit(HybridBlock):
    """One residual unit. ``preact=False`` is the v1 ordering
    (conv-BN-relu ... + identity, relu after the add); ``preact=True`` is
    the v2 ordering (BN-relu-conv ..., identity added raw, and the
    downsample path branches from the ACTIVATED input)."""

    def __init__(self, kind, channels, stride, downsample=False,
                 in_channels=0, preact=False, remat=False,
                 remat_policy="full", **kwargs):
        super().__init__(**kwargs)
        if remat:
            raise _no_remat("_ResidualUnit(remat=True)")
        self._preact = preact
        plan = _conv_plan(kind, channels, stride, preact)
        self.body = nn.HybridSequential(prefix="")
        for i, (c, k, s, p, bias) in enumerate(plan):
            if preact:
                self.body.add(nn.BatchNorm(), nn.Activation("relu"))
            self.body.add(nn.Conv2D(c, kernel_size=k, strides=s, padding=p,
                                    use_bias=bias))
            if not preact:
                self.body.add(nn.BatchNorm())
                if i < len(plan) - 1:
                    self.body.add(nn.Activation("relu"))
        if not downsample:
            self.downsample = None
        elif preact:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(
                nn.Conv2D(channels, 1, stride, use_bias=False,
                          in_channels=in_channels),
                nn.BatchNorm())

    def hybrid_forward(self, F, x):
        if self._preact:
            # v2: the first BN-relu of the body also feeds the shortcut
            cells = list(self.body)
            pre = cells[1](cells[0](x))
            shortcut = self.downsample(pre) if self.downsample else x
            out = pre
            for layer in cells[2:]:
                out = layer(out)
            return out + shortcut
        shortcut = self.downsample(x) if self.downsample else x
        return F.Activation(self.body(x) + shortcut, act_type="relu")


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


class _ResNet(HybridBlock):
    """Assembler: stem -> stages of residual units -> pool -> classifier.

    v2 (preact) wraps the stages with the reference's extra input BN
    (scale/center off) and a final BN-relu before pooling."""

    def __init__(self, kind, layers, channels, preact, classes=1000,
                 thumbnail=False, unit_factory=None, remat_stages=None,
                 remat_policy=None, device=None, seed=0, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        if remat_stages is None:
            env = os.environ.get("MXTPU_RESNET_REMAT", "")
            remat_stages = {s.strip() for s in env.split(",") if s.strip()}
        if remat_stages:
            raise _no_remat("remat_stages=%s" % sorted(remat_stages))
        self._preact = preact
        if unit_factory is None:
            def unit_factory(out_c, stride, downsample, in_c):
                return _ResidualUnit(kind, out_c, stride, downsample,
                                     in_channels=in_c, preact=preact,
                                     prefix="")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if preact:
                self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False),
                                  nn.BatchNorm(), nn.Activation("relu"),
                                  nn.MaxPool2D(3, 2, 1))
            in_c = channels[0]
            for i, (n_units, out_c) in enumerate(zip(layers, channels[1:])):
                stage = nn.HybridSequential(prefix="stage%d_" % (i + 1))
                with stage.name_scope():
                    for j in range(n_units):
                        stride = 2 if (i > 0 and j == 0) else 1
                        stage.add(unit_factory(out_c, stride,
                                               j == 0 and out_c != in_c,
                                               in_c))
                        in_c = out_c
                self.features.add(stage)
            if preact:
                self.features.add(nn.BatchNorm(), nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            if preact:
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=channels[-1])
        if device is not None:
            self._materialize(resolve_device(device), seed,
                              8 if thumbnail else 32)

    def _materialize(self, device, seed, size):
        """Every shape inferred on ``device`` (zeros: no draw from numpy's
        RNG), then ``init_params(seed)``."""
        self.initialize(_init.Zero(), ctx=device)
        self.infer_shape(torch.zeros(1, 3, size, size, device=device))
        nn.init_params(self, seed)

    @property
    def device(self):
        return self.output.weight.data().context

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _block_factory(block):
    """ResNetV1/V2 instantiate the block class the caller passes."""
    def make(out_c, stride, downsample, in_c):
        return block(out_c, stride, downsample, in_channels=in_c, prefix="")
    return make


class ResNetV1(_ResNet):
    def __init__(self, block, layers, channels, **kwargs):
        super().__init__("custom", layers, channels, preact=False,
                         unit_factory=_block_factory(block), **kwargs)


class ResNetV2(_ResNet):
    def __init__(self, block, layers, channels, **kwargs):
        super().__init__("custom", layers, channels, preact=True,
                         unit_factory=_block_factory(block), **kwargs)


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
    builds the model ready on that device; without it, ``initialize``
    places it)."""
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
    """Fill ``net``'s parameters and running statistics (every shape known)
    from ``params``, a
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
