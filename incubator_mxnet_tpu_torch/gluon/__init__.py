"""Gluon of the PyTorch port: Block / HybridBlock, Parameter /
ParameterDict, the layers of ``nn``, the fused layers of ``rnn``, the
losses, the local ``Trainer`` and the ResNet model zoo (counterpart of
``incubator_mxnet_tpu/gluon/``). The other layers, the recurrent cells,
``contrib``, ``data`` and ``utils`` wait for ROADMAP Queue 1 items 6, 10 and
11."""

from . import loss, model_zoo, nn, rnn
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "nn", "rnn", "loss",
           "model_zoo"]
