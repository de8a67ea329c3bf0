"""Gluon of the PyTorch port: Block / HybridBlock, Parameter /
ParameterDict, the layers of ``nn``, the losses, the local ``Trainer`` and
the ResNet model zoo (counterpart of ``incubator_mxnet_tpu/gluon/``). The
other layers, ``rnn``, ``contrib``, ``data`` and ``utils`` wait for ROADMAP
Queue 1 items 3, 9 and 10."""

from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "nn", "loss",
           "model_zoo"]
