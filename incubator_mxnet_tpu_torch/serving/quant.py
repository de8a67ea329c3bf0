"""The int8 path of the serving decode head.

Counterpart of ``incubator_mxnet_tpu/serving/quant.py``. ``Int8Dense``
computes ``x @ W.T + b`` with the weight quantized once, at construction
(symmetric, zero-point free: ``ops.quantization.quantize_v2``), and again,
in place, by ``requantize_`` when a live swap brings new weights; the
activation is quantized on every call, per tensor over the whole (rows, in)
block. The int8 x int8 -> int32 product goes through
``ops/kernels/int8_matmul.py`` (the hand-written kernel on a CUDA device,
its plain version on the CPU); the accumulator is rescaled to float32 by
``(x_amax * w_amax) / 127**2`` and the float32 bias added after, step for
step as the JAX package does. Weight, bias and scales stay on the model's
device; only what the caller asks for leaves it.

The weight is kept zero-padded in K to a multiple of 16, and each call pads
the activation codes the same way: zeros add nothing to the sum, and the
padded rows are 16-byte aligned, which the kernel's vector loads need.

A call reads no host value: the weight's amax is a 0-d tensor on the device,
so a CUDA graph captured over a call reads the codes, the scale and the bias
where they live, and ``requantize_`` rewrites all three there. (The JAX
package rebuilds a new ``Int8Dense`` on a swap; a new object would leave a
captured graph reading the old buffers.) ``codes`` is the last call's padded
activation codes: under a graph, the buffer each replay rewrites.

Enabled per model by ``load_served_model(..., quantize=True)``, or for
``quantize=None`` by ``MXTPU_SERVE_INT8`` (``int8_serving_enabled``).
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..context import resolve_device
from ..ops.kernels.int8_matmul import int8_matmul_nk
from ..ops.quantization import quantize_v2

__all__ = ["Int8Dense", "int8_serving_enabled"]

_K_ALIGN = 16


def int8_serving_enabled():
    return os.environ.get("MXTPU_SERVE_INT8", "0") in ("1", "true", "on")


def _as_f32(value, device):
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


class Int8Dense:
    """Drop-in for ``x @ W.T + b`` with a pre-quantized weight.

    weight : (out, in) float; bias : (out,) or None; device : where the
    quantized weight lives (None: the weight tensor's device, ``cuda:0``
    for an array). ``__call__(x)`` with x (rows, in) float32 on that device
    (an array is moved there) -> (rows, out) float32 tensor."""

    def __init__(self, weight, bias=None, device=None):
        if device is None and isinstance(weight, torch.Tensor):
            device = weight.device
        device = resolve_device(device)
        w = _as_f32(weight, device)
        qw, _wmin, wmax = quantize_v2(w)
        self.out_features, self.in_features = w.shape
        pad = -self.in_features % _K_ALIGN
        self._pad = pad
        self._qw = F.pad(qw, (0, pad)).contiguous()     # (out, in + pad)
        self._w_amax = wmax.detach().clone()            # 0-d, on device
        self._bias = (_as_f32(bias, device).clone() if bias is not None
                      else None)
        self.device = device
        self.codes = None

    @property
    def w_amax(self):
        """The weight's amax as a float (reads it back from the device)."""
        return float(self._w_amax)

    def requantize_(self, weight, bias=None):
        """Quantize a new (out, in) weight (and bias) into this head's own
        buffers: the codes into ``_qw`` (K padding kept zero), the amax
        into ``_w_amax`` and the bias into ``_bias``, all in place. The
        result equals a new ``Int8Dense(weight, bias)`` bit for bit."""
        with torch.inference_mode():
            w = _as_f32(weight, self.device)
            if tuple(w.shape) != (self.out_features, self.in_features):
                raise ValueError("requantize_: weight %s, the head is %s"
                                 % (tuple(w.shape), (self.out_features,
                                                     self.in_features)))
            if (bias is None) != (self._bias is None):
                raise ValueError("requantize_: the head %s a bias"
                                 % ("has" if self._bias is not None
                                    else "has no"))
            qw, _wmin, wmax = quantize_v2(w)
            self._qw[:, :self.in_features].copy_(qw)
            self._w_amax.copy_(wmax)
            if bias is not None:
                b = _as_f32(bias, self.device)
                if tuple(b.shape) != tuple(self._bias.shape):
                    raise ValueError("requantize_: bias %s, the head's is %s"
                                     % (tuple(b.shape),
                                        tuple(self._bias.shape)))
                self._bias.copy_(b)
        return self

    def _accumulate(self, qx):
        """(rows, in) int8 -> (rows, out) int32."""
        self.codes = F.pad(qx, (0, self._pad)).contiguous()
        return int8_matmul_nk(self.codes, self._qw)

    def __call__(self, x):
        x = _as_f32(x, self.device)
        qx, _xmin, xmax = quantize_v2(x)
        acc = self._accumulate(qx)
        # one int32 unit = (x_amax / 127) * (w_amax / 127)
        scale = (xmax * self._w_amax) / (127.0 * 127.0)
        y = acc.to(torch.float32) * scale
        if self._bias is not None:
            y = y + self._bias
        return y
