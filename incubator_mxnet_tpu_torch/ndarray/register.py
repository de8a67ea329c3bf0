"""The ``nd.<op>`` functions, generated from the op registry.

Counterpart of ``incubator_mxnet_tpu/ndarray/register.py``: one function
for every name of the op table. A bound op runs on the tensors of its
NDArray arguments, recorded iff ``autograd.is_recording()``, and returns
NDArrays; called with tensors only, it returns tensors (the layers of
``gluon`` run the same ``hybrid_forward`` on either). A name that is not
ported yet raises NotImplementedError when called.
"""

from ..ops.registry import get_op, table_names
from .ndarray import NDArray, invoke

__all__ = ["make_op_func"]


def make_op_func(name):
    def op_func(*args, **kwargs):
        info = get_op(name)
        if any(isinstance(a, NDArray)
               for a in list(args) + list(kwargs.values())):
            return invoke(info.fn, *args, **kwargs)
        return info.fn(*args, **kwargs)
    op_func.__name__ = name
    op_func.__doc__ = "The %r operator (ops/registry.py)." % name
    return op_func


def _init_op_functions(namespace):
    """One function per op name or alias in ``namespace``, leaving names
    that are defined there already."""
    for name in table_names():
        if name not in namespace:
            namespace[name] = make_op_func(name)
