"""Tensor operators of the eager gluon path: ``pick``.

Counterpart of the part of ``incubator_mxnet_tpu/ops/tensor.py`` that the
path calls; the rest of that file is ROADMAP Queue 1 item 9.
"""

import torch

from .registry import register

__all__ = ["pick"]


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``; the index is cast to an
    integer and clipped into range (``mode="clip"``, the JAX package's only
    mode)."""
    axis = axis % data.dim()
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)
