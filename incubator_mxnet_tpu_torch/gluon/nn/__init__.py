"""gluon.nn: the layers of the ResNet and word-LM paths on the port's
HybridBlock (counterpart of ``incubator_mxnet_tpu/gluon/nn/``). The other
layers, the advanced activations of ``activations.py`` among them, wait for
the rest of the op surface (ROADMAP Queue 1 items 6 and 10)."""

from ..block import Block, HybridBlock
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, init_params)
from .conv_layers import AvgPool2D, Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Block", "HybridBlock", "Activation", "BatchNorm", "Dense",
           "Dropout", "Embedding", "Flatten", "HybridSequential",
           "init_params", "Conv2D", "MaxPool2D", "AvgPool2D",
           "GlobalAvgPool2D"]
