"""Shared basics of the PyTorch port: the error type, dtype names and the
numeric type tuples.

Counterpart of ``incubator_mxnet_tpu/base.py``: dtype names resolve to
``torch.dtype``s instead of JAX's.
"""

import numpy as _np
import torch

__all__ = ["MXNetError", "TPUFrameworkError", "numeric_types",
           "integer_types", "string_types", "dtype_torch", "dtype_name",
           "default_dtype"]


class MXNetError(RuntimeError):
    """Framework error type (reference: MXNetError from c_api errors)."""


# new-name alias; both are exported
TPUFrameworkError = MXNetError

numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)
string_types = (str,)

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def dtype_torch(dtype):
    """A dtype-ish (name, numpy dtype or type, torch dtype, None) as a
    ``torch.dtype``; None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def dtype_name(dtype):
    """Canonical string name of a dtype."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return _np.dtype(dtype).name


def default_dtype():
    return _np.float32
