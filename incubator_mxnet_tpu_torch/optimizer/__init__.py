"""Optimizers of the PyTorch port (counterpart of
``incubator_mxnet_tpu/optimizer/``)."""

from .optimizer import (NAG, SGD, Adam, AdamW, Optimizer, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "NAG", "Adam", "AdamW"]
