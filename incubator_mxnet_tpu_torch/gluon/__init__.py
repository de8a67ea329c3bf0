"""Gluon's layers and model zoo as ``torch.nn.Module``s. Counterpart of
``incubator_mxnet_tpu/gluon/`` for the layers the ResNet path uses; the
block, parameter and trainer core is ROADMAP Queue 1 items 3 and 4."""

from . import model_zoo, nn

__all__ = ["nn", "model_zoo"]
