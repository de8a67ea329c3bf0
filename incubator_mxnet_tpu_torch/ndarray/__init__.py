"""The imperative NDArray frontend (the ``mx.nd`` namespace) of the PyTorch
port: the NDArray class, creation, ``save`` / ``load``, and one function
for every op name of the registry (``register.py``)."""

from .. import ops as _ops  # noqa: F401
from ..ops import nn as _nn, quantization as _quantization, rnn as _rnn, \
    tensor as _tensor  # noqa: F401  (bind the ops)
from .ndarray import (NDArray, arange, array, empty, full, invoke, load,
                      ones, save, waitall, zeros)
from .register import _init_op_functions

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "save", "load", "waitall", "invoke"]

_init_op_functions(globals())
