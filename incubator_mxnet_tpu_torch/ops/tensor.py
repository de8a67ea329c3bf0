"""Tensor operators of the eager gluon path: ``pick`` and ``Embedding``.

Counterpart of the part of ``incubator_mxnet_tpu/ops/tensor.py`` that the
ported paths call; the rest of that file is ROADMAP Queue 1 item 5.
"""

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["pick", "embedding_op"]


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``; the index is cast to an
    integer and clipped into range (``mode="clip"``, the JAX package's only
    mode)."""
    axis = axis % data.dim()
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register("Embedding")
def embedding_op(data, weight, input_dim=None, output_dim=None,
                 dtype="float32", sparse_grad=False):
    """The reference's ``Embedding`` op: rows of ``weight`` (input_dim,
    output_dim) at the integer ids of ``data`` (any shape). Ids outside
    [0, input_dim) raise ValueError (the JAX package's gather clamps them;
    on the card an out-of-range index is a device fault). On a CUDA tensor
    the check reads the ids' range back to the host."""
    if sparse_grad:
        raise NotImplementedError("Embedding(sparse_grad=True): sparse "
                                  "gradients are not ported yet (ROADMAP "
                                  "Queue 1 item 4)")
    ids = data.long()
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= weight.shape[0]:
            raise ValueError("Embedding ids must lie in [0, %d), got [%d, "
                             "%d]" % (weight.shape[0], lo, hi))
    return F.embedding(ids, weight)
