"""Loss layers — Block shells over the kernels in ``ops.losses``.

Counterpart of ``incubator_mxnet_tpu/gluon/loss.py`` for ``Loss``,
``L2Loss``, ``L1Loss`` and ``SoftmaxCrossEntropyLoss`` (``SoftmaxCELoss``).
Each class binds its constructor options and runs its kernel on the
tensors of NDArray inputs, recorded under ``autograd.record()``, or on
tensors directly. The other losses of the JAX package wait for ROADMAP
Queue 1 item 5.
"""

import functools

from ..ndarray import NDArray, invoke
from ..ops import losses as _L
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Base: subclasses set ``_kernel`` (a function of ops.losses) and
    ``_options()`` (constructor state forwarded as keywords)."""

    _kernel = None

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _options(self):
        return {"weight": self._weight, "batch_axis": self._batch_axis}

    def _run(self, *args):
        kernel = functools.partial(type(self)._kernel, **self._options())
        if any(isinstance(a, NDArray) for a in args):
            return invoke(kernel, *args)
        return kernel(*args)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        return self._run(pred, label, sample_weight)

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)


class L2Loss(Loss):
    _kernel = staticmethod(_L.l2_loss)

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)


class L1Loss(Loss):
    _kernel = staticmethod(_L.l1_loss)

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)


class SoftmaxCrossEntropyLoss(Loss):
    _kernel = staticmethod(_L.softmax_ce)

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _options(self):
        return {**super()._options(), "axis": self._axis,
                "sparse_label": self._sparse_label,
                "from_logits": self._from_logits}


SoftmaxCELoss = SoftmaxCrossEntropyLoss
