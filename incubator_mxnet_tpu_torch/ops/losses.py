"""Loss kernels of the eager gluon path, as plain PyTorch.

Counterpart of the part of ``incubator_mxnet_tpu/ops/losses.py`` that
``gluon.loss`` binds here: ``l2_loss``, ``l1_loss`` and ``softmax_ce``. Each
reduces with the mean over every axis except ``batch_axis`` (the
reference's ``F.mean(..., exclude=True)``). The other losses of that file
wait for ROADMAP Queue 1 item 5.
"""

import torch

__all__ = ["l1_loss", "l2_loss", "softmax_ce"]


def _batch_mean(loss, batch_axis):
    """Mean over every axis except the batch axis."""
    if loss.dim() <= 1:
        return loss
    axes = tuple(i for i in range(loss.dim())
                 if i != batch_axis % loss.dim())
    return loss.mean(dim=axes)


def _finish(loss, weight, sample_weight, batch_axis):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return _batch_mean(loss, batch_axis)


def l2_loss(pred, label, sample_weight=None, *, weight=1.0, batch_axis=0):
    err = pred - label.reshape(pred.shape)
    return _finish(0.5 * err * err, weight, sample_weight, batch_axis)


def l1_loss(pred, label, sample_weight=None, *, weight=None, batch_axis=0):
    err = torch.abs(pred - label.reshape(pred.shape))
    return _finish(err, weight, sample_weight, batch_axis)


def softmax_ce(pred, label, sample_weight=None, *, axis=-1,
               sparse_label=True, from_logits=False, weight=None,
               batch_axis=0):
    """Softmax cross-entropy; sparse labels may come as floats (cast to an
    integer class index, as the JAX package casts them)."""
    if not from_logits:
        pred = torch.log_softmax(pred, dim=axis)
    if sparse_label:
        idx = label.long().unsqueeze(axis)
        loss = -torch.gather(pred, axis % pred.dim(), idx)
    else:
        loss = -(pred * label.reshape(pred.shape)).sum(dim=axis,
                                                       keepdim=True)
    return _finish(loss, weight, sample_weight, batch_axis)
