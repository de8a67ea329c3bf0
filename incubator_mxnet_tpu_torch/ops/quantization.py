"""INT8 quantization operators of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/ops/quantization.py`` (``:22-79``):
``quantize_v2``, ``dequantize``, ``requantize`` and
``quantized_fully_connected``, bound to the JAX package's op names and
aliases. Quantization is symmetric and zero-point free: ``amax`` maps to
127, codes are ``clamp(round(x * 127 / amax), -127, 127)`` with round half
to even, every scale is computed in float32 in the JAX package's order.

``quantized_fully_connected`` accumulates int8 x int8 in int32 through
``ops/kernels/int8_matmul.py``: the hand-written kernel for CUDA tensors,
its plain version for CPU ones. ``quantized_conv``, ``quantized_pooling``
and ``quantized_flatten`` and the calibration helpers wait for ROADMAP
Queue 1 item 10.
"""

import torch

from .kernels.int8_matmul import int8_matmul_nk
from .registry import register

__all__ = ["quantize_v2", "dequantize", "requantize",
           "quantized_fully_connected"]


def _scalar(value, like):
    """A Python number as a 0-dim float32 tensor beside ``like``."""
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


def _amax(lo, hi):
    return torch.maximum(lo.abs(), hi.abs())


def _codes(x, amax):
    scale = 127.0 / torch.clamp(amax, min=1e-30)
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


@register("quantize_v2", num_outputs=3)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float -> (int8 codes, -amax, amax), amax the tensor's largest
    magnitude or the calibrated range's."""
    if min_calib_range is None:
        amax = data.abs().max()
    else:
        amax = _scalar(max(abs(float(min_calib_range)),
                           abs(float(max_calib_range))), data)
    return _codes(data, amax), -amax, amax


@register("dequantize")
def dequantize(data, min_range, max_range, out_type="float32"):
    return data.to(torch.float32) * (_amax(min_range, max_range) / 127.0)


@register("requantize", num_outputs=3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> (int8 codes, -amax, amax) in a new range."""
    in_scale = _amax(min_range, max_range) / (127.0 * 127.0)
    real = data.to(torch.float32) * in_scale
    if min_calib_range is not None:
        out_amax = _scalar(max(abs(float(min_calib_range)),
                               abs(float(max_calib_range))), real)
    else:
        out_amax = real.abs().max()
    return _codes(real, out_amax), -out_amax, out_amax


@register("quantized_fully_connected", num_outputs=3)
def quantized_fully_connected(data, weight, bias=None, data_min=None,
                              data_max=None, weight_min=None,
                              weight_max=None, bias_min=None, bias_max=None,
                              num_hidden=None, no_bias=False, flatten=True):
    """int8 data (rows, in) x int8 weight (out, in) -> (int32 accumulator,
    -amax, amax), one accumulator unit being amax / 127**2. An int8 bias
    with its own range is rounded into accumulator units and added."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    acc = int8_matmul_nk(data.reshape(-1, data.shape[-1]).contiguous(),
                         weight.contiguous())
    acc = acc.reshape(*lead, weight.shape[0])
    out_amax = _amax(data_min, data_max) * _amax(weight_min, weight_max)
    if bias is not None and not no_bias:
        b_real = bias.to(torch.float32) * (_amax(bias_min, bias_max) / 127.0)
        unit = torch.clamp(out_amax / (127.0 * 127.0), min=1e-30)
        acc = acc + torch.round(b_real / unit).to(torch.int32)
    return acc, -out_amax, out_amax


def _waits(name):
    def op(*_args, **_kwargs):
        raise NotImplementedError("%s is not ported yet (ROADMAP Queue 1 "
                                  "item 10)" % name)
    op.__name__ = name
    return op


for _name in ("quantized_conv", "quantized_pooling", "quantized_flatten"):
    register(_name, num_outputs=3)(_waits(_name))
