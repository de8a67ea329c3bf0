"""Neural-network operators of the BERT and ResNet paths.

Counterpart of a subset of ``incubator_mxnet_tpu/ops/nn.py`` (plus
``Embedding`` from ``ops/tensor.py``), with the same argument names and
layouts (NC(D)HW for convolution, pooling and BatchNorm). LayerNorm and
softmax go through the hand-written kernels in ``ops/kernels/fused_norm.py``
on every axis; the matrix products stay ``torch.matmul`` and the
convolutions ``F.conv*d``, as the JAX package left them to XLA. BatchNorm's
training mode is the JAX package's one-pass custom VJP (``_make_bn_train``)
written again as a ``torch.autograd.Function``; it is not
``F.batch_norm``, whose running variance is unbiased and whose momentum is
the weight of the new statistic.

The functions of the eager gluon path are bound to their op names in
``ops/registry.py`` (FullyConnected, Convolution, BatchNorm, Pooling,
Activation, Flatten, softmax, log_softmax), which the ``nd`` namespace
calls.
"""

import torch
import torch.nn.functional as F

from .kernels import fused_norm
from .registry import register

__all__ = ["fully_connected", "embedding", "layer_norm", "softmax",
           "log_softmax", "activation", "leaky_relu", "convolution",
           "pooling", "batch_norm", "flatten"]


@register("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x @ W^T + b, with weight (num_hidden, in_units) as in the
    reference."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


def embedding(data, weight):
    """Integer-id row gather from ``weight`` (input_dim, output_dim). A
    bf16 or fp16 weight on the CPU is gathered from its fp32 widening and
    the rows rounded back (the same values), so that its gradient is summed
    in fp32, as PyTorch's CUDA kernel sums it; the CPU kernel would sum
    the rows of a repeated id in bf16, which loses most of a long sum."""
    if weight.device.type == "cpu" and weight.dtype in (torch.bfloat16,
                                                        torch.float16):
        return F.embedding(data.long(), weight.float()).to(weight.dtype)
    return F.embedding(data.long(), weight)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis``; every axis goes through the
    LayerNorm kernel (a non-last axis is moved last and back)."""
    axis = axis % data.dim()
    if axis == data.dim() - 1:
        return fused_norm.layer_norm(data.contiguous(), gamma, beta, eps)
    moved = data.movedim(axis, -1).contiguous()
    return fused_norm.layer_norm(moved, gamma, beta, eps).movedim(-1, axis)


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None, use_length=False):
    """Softmax over ``axis``; temperature and the length mask apply before
    the kernel, as in the JAX package."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    axis = axis % data.dim()
    if use_length and length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        bshape = [1] * data.dim()
        bshape[axis] = data.shape[axis]
        mask = steps.reshape(bshape) < length.reshape(
            [length.shape[0]] + [1] * (data.dim() - 1))
        data = data.masked_fill(~mask, float("-inf"))
    if axis == data.dim() - 1:
        return fused_norm.softmax(data.contiguous())
    moved = data.movedim(axis, -1).contiguous()
    return fused_norm.softmax(moved).movedim(-1, axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    """log(softmax) over ``axis`` in one plain PyTorch operation, as the
    JAX package computes it (no kernel)."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register("Activation")
def activation(data, act_type="relu"):
    """relu / sigmoid / tanh / softrelu / softsign by act_type."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise ValueError("unknown act_type %r" % act_type)


def leaky_relu(data, act_type="leaky", slope=0.25):
    """leaky / gelu (exact, through erf) by act_type."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise ValueError("unknown act_type %r" % act_type)


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **_ignored):
    """Grouped N-D convolution, NC(D)HW; weight (num_filter, C / num_group,
    *kernel). The JAX package's space-to-depth form of the 7x7/2 RGB stem
    (``MXTPU_CONV1_S2D``) is the same function in another summation order
    and is not carried over."""
    sd = data.dim() - 2
    if sd not in _CONV:
        raise ValueError("convolution: data must be 3-D to 5-D, got %d-D"
                         % data.dim())
    stride, dilate = _tup(stride, sd), _tup(dilate, sd)
    pad = _tup(pad, sd) if pad is not None else (0,) * sd
    b = bias if bias is not None and not no_bias else None
    return _CONV[sd](data, weight, b, stride=stride, padding=pad,
                     dilation=dilate, groups=num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, p_value=2, **_ignored):
    """Max / avg / sum pooling, N-D NC(D)HW. Max pads with -inf (a tie
    sends the gradient to the window's first maximum, as JAX's
    reduce_window gradient does on the CPU); avg divides by the whole
    window with ``count_include_pad``, else by its in-image part.
    ``pooling_convention="full"`` (ceil mode) and ``lp`` are Queue 1
    item 5."""
    sd = data.dim() - 2
    if sd not in _MAX_POOL:
        raise ValueError("pooling: data must be 3-D to 5-D, got %d-D"
                         % data.dim())
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % pool_type)
    if pool_type == "lp":
        raise NotImplementedError("pooling: pool_type 'lp' is not ported "
                                  "yet (ROADMAP Queue 1 item 5)")
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        s = data.sum(dim=dims, keepdim=True)
        if pool_type == "sum":
            return s
        n = 1
        for d in dims:
            n *= data.shape[d]
        return s / n
    if pooling_convention == "full":
        raise NotImplementedError("pooling: pooling_convention 'full' (ceil "
                                  "mode) is not ported yet (ROADMAP Queue 1 "
                                  "item 5)")
    kernel = _tup(kernel, sd)
    stride = _tup(stride, sd) if stride is not None else (1,) * sd
    pad = _tup(pad, sd) if pad is not None else (0,) * sd
    if pool_type == "max":
        return _MAX_POOL[sd](data, kernel, stride, pad)
    if pool_type == "sum":
        if sd == 1:             # avg_pool1d has no divisor_override
            return F.avg_pool2d(data[..., None], kernel + (1,),
                                stride + (1,), pad + (0,),
                                divisor_override=1)[..., 0]
        return _AVG_POOL[sd](data, kernel, stride, pad, divisor_override=1)
    return _AVG_POOL[sd](data, kernel, stride, pad,
                         count_include_pad=bool(count_include_pad))


def _bn_geometry(data, axis):
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = tuple(-1 if i == axis else 1 for i in range(data.dim()))
    n = 1
    for i in red:
        n *= data.shape[i]
    return red, bshape, float(n)


class _BatchNormTrain(torch.autograd.Function):
    """The JAX package's ``_make_bn_train``: forward s1 = sum x and
    s2 = sum x^2 in fp32, mean = s1 / n, var = max(s2 / n - mean^2, 0) (the
    biased variance), out = x * scale + shift; backward dbeta = sum dy,
    dgamma = sum dy * xhat, dx = k * (dy - dbeta / n - xhat * dgamma / n)
    with k = gamma * rsqrt(var + eps). mean and var carry no gradient."""

    @staticmethod
    def forward(ctx, data, gamma, beta, axis, eps):
        red, bshape, n = _bn_geometry(data, axis)
        f32 = torch.float32
        s1 = data.sum(dim=red, dtype=f32)
        xf = data.float()
        s2 = (xf * xf).sum(dim=red)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        scale = gamma.float() * inv
        shift = beta.float() - mean * scale
        out = data * scale.to(data.dtype).reshape(bshape) \
            + shift.to(data.dtype).reshape(bshape)
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.axis, ctx.beta_dtype = axis, beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, gamma, mean, inv = ctx.saved_tensors
        red, bshape, n = _bn_geometry(data, ctx.axis)
        dyf = dy.float()
        xhat = (data.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        dbeta = dyf.sum(dim=red)
        dgamma = (dyf * xhat).sum(dim=red)
        dt = data.dtype
        k = (gamma.float() * inv).to(dt).reshape(bshape)
        dx = k * (dy - (dbeta / n).to(dt).reshape(bshape)
                  - xhat.to(dt) * (dgamma / n).to(dt).reshape(bshape))
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None, \
            None


@register("BatchNorm", num_outputs=3)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=False, **_ignored):
    """Returns (out, new_moving_mean, new_moving_var). Training mode (and
    not ``use_global_stats``) normalizes with the batch statistics through
    ``_BatchNormTrain`` and moves the moving ones as
    ``momentum * moving + (1 - momentum) * batch``, with the biased
    variance; otherwise it normalizes with the moving statistics and
    returns them unchanged. ``fix_gamma`` uses a gamma of ones."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    axis = int(axis) % data.dim()
    if training and not use_global_stats:
        out, mean, var = _BatchNormTrain.apply(data, gamma, beta, axis,
                                               float(eps))
        mean = mean.to(moving_mean.dtype)
        var = var.to(moving_var.dtype)
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
        return out, new_mean, new_var
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.dim()))
    inv = torch.rsqrt(moving_var.float() + eps).to(data.dtype)
    out = (data - moving_mean.reshape(bshape).to(data.dtype)) \
        * (gamma * inv).reshape(bshape) + beta.reshape(bshape)
    return out, moving_mean, moving_var


@register("Flatten")
def flatten(data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)
