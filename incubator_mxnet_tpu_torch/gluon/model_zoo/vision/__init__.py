"""Vision model zoo: the ResNet families (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/``). The zoo's other families
wait for the rest of the op surface (ROADMAP Queue 1 item 10);
``get_model`` names them and raises."""

from .resnet import *  # noqa: F401,F403
from .resnet import (__all__ as _resnet_all, get_resnet, params_from_jax,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

__all__ = list(_resnet_all) + ["get_model"]

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}

# the JAX package's other zoo names, not ported yet
_LATER = ("alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
          "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
          "squeezenet1.1", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
          "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
          "mobilenetv2_0.5", "mobilenetv2_0.25", "densenet121",
          "densenet161", "densenet169", "densenet201", "inceptionv3",
          "inception_v3", "resnext50_32x4d", "resnext101_32x4d",
          "resnext101_64x4d")
_LATER = frozenset(_LATER) | {k.replace(".", "_") for k in _LATER}


def get_model(name, **kwargs):
    """A ResNet of the zoo by name (``resnet50_v1``, ...), built with
    ``kwargs`` (``device``, ``classes``, ...)."""
    name = name.lower()
    if name in _models:
        return _models[name](**kwargs)
    if name in _LATER:
        raise NotImplementedError("model %s is not ported yet (ROADMAP "
                                  "Queue 1 item 10)" % name)
    raise ValueError("Model %s not supported. Available: %s"
                     % (name, sorted(_models)))
