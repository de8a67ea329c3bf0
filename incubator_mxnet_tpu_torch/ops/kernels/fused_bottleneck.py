"""One fused ResNet stage-1 bottleneck unit in inference mode: the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/fused_bottleneck.py``
(``fused_bottleneck`` and ``bottleneck_reference``), with its layouts:
x (B, H, W, C) NHWC; w1 (C, M); w2 (9, M, M) with taps ``ky * 3 + kx``;
w3 (M, C); s1, b1, s2, b2 (M,) and s3, b3 (C,) the folded BN scale and
shift in fp32. It computes

    relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x)))))))) + x)

with fp32 accumulation, h1 and h2 rounded to x's dtype where the TPU kernel
rounds them, and the output in x's dtype (fp32, bf16 or fp16). The kernels
are in
``csrc/fused_bottleneck.cu``: a block owns an 8 x 14 tile of output pixels,
keeps h1 (on the tile and a one-pixel halo) and h2 in shared memory, and
runs the three products on the tensor cores: bf16 x bf16 -> fp32 in bf16,
fp16 x fp16 -> fp32 in fp16 (the bf16 kernel's body on another element
type), and in fp32 as three TF32 products each (3xTF32: the operands split into
tf32 halves, hi*lo + lo*hi + hi*hi of every one or two k-steps into a fresh
accumulator added in fp32), which keeps fp32's accuracy to ~2^-21 of each
product.

For a CPU tensor ``fused_bottleneck`` takes the plain version; for CUDA
tensors it launches the kernel or raises, and adds one to its ``launches``
count. The kernel takes M up to 64 and any B, H, W and C. ``_route`` picks
its route from the dtype, the shape and the operands' addresses:
``"fp32"`` (any operands: the C entry takes 16-byte copies where every base
is 16-byte aligned, C % 4 == 0 and M % 4 == 0, else 4-byte ones); ``"bf16"``
(16-byte loads: every bf16 base 16-byte aligned, C % 8 == 0 and
M % 8 == 0); ``"bf16_scalar"`` (element-wise loads, any operands);
``"fp16"`` and ``"fp16_scalar"`` under the same conditions. The C entry
refuses a route whose condition fails. fp16 rounds h1, h2 and the output to
nearest even with no saturation: a value past 65504 becomes inf, and an inf
h1 times a zero weight of the 3x3 conv gives NaN, as in the JAX kernel;
ReLU passes NaN through.
"""

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_bottleneck", "bottleneck_reference"]

MAX_M = 64                 # widest bottleneck the kernel holds (kMaxM)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the C entry's route codes
ROUTES = {"fp32": 0, "bf16": 1, "bf16_scalar": 2, "fp16": 3,
          "fp16_scalar": 4}
_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16"}


def _route(dtype, C, M, ptrs):
    """The kernel's route for x of `dtype` with C channels, a bottleneck of
    width M, and the byte addresses `ptrs` of x, w1, w2, w3 and the
    output."""
    if dtype == torch.float32:
        return "fp32"
    if C % 8 == 0 and M % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return _NAMES[dtype]
    return _NAMES[dtype] + "_scalar"


def bottleneck_reference(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The same unit through ``F.conv2d`` in fp32 on x's values (bf16 and
    fp16 values are exact in fp32), with the same roundings: h1 and h2 to
    x's dtype after their BN and ReLU, the output after the residual and
    ReLU (an fp16 value past 65504 becomes inf there).
    As the JAX package's ``bottleneck_reference`` asks its convs for fp32
    results (``preferred_element_type``)."""
    dt = x.dtype
    C, M = w1.shape
    xf = x.float().permute(0, 3, 1, 2)                  # NCHW view, fp32

    def bn(h, s, b):
        return h * s.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)

    h = F.conv2d(xf, w1.float().t().reshape(M, C, 1, 1))
    h = torch.relu(bn(h, s1, b1)).to(dt).float()
    # (ky, kx, in, out) -> (out, in, ky, kx)
    k2 = w2.float().reshape(3, 3, M, M).permute(3, 2, 0, 1)
    h = F.conv2d(h, k2, padding=1)
    h = torch.relu(bn(h, s2, b2)).to(dt).float()
    h = F.conv2d(h, w3.float().t().reshape(C, M, 1, 1))
    out = torch.relu(bn(h, s3, b3) + xf).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def _check_cuda(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    if x.dim() != 4:
        raise ValueError("fused_bottleneck: x must be (B, H, W, C), got %s"
                         % (tuple(x.shape),))
    B, H, W, C = x.shape
    if w1.dim() != 2 or w1.shape[0] != C:
        raise ValueError("fused_bottleneck: w1 must be (%d, M), got %s"
                         % (C, tuple(w1.shape)))
    M = w1.shape[1]
    want = {"w1": (C, M), "w2": (9, M, M), "w3": (M, C), "s1": (M,),
            "b1": (M,), "s2": (M,), "b2": (M,), "s3": (C,), "b3": (C,)}
    named = dict(w1=w1, s1=s1, b1=b1, w2=w2, s2=s2, b2=b2, w3=w3, s3=s3,
                 b3=b3)
    if x.dtype not in _DTYPES:
        raise TypeError("fused_bottleneck: the CUDA kernel takes float32, "
                        "bfloat16 or float16 x, got %s" % x.dtype)
    for name, t in [("x", x)] + list(named.items()):
        if t.device != x.device:
            raise ValueError("fused_bottleneck: %s on %s, x on %s"
                             % (name, t.device, x.device))
        if not t.is_contiguous():
            raise ValueError("fused_bottleneck: %s is not contiguous" % name)
        if name == "x":
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError("fused_bottleneck: %s has shape %s, expected %s"
                             % (name, tuple(t.shape), want[name]))
        dtype = x.dtype if name.startswith("w") else torch.float32
        if t.dtype != dtype:
            raise TypeError("fused_bottleneck: %s must be %s, got %s"
                            % (name, dtype, t.dtype))
    if not 1 <= M <= MAX_M:
        raise ValueError("fused_bottleneck: the kernel takes 1 <= M <= %d, "
                         "got %d" % (MAX_M, M))
    if not 1 <= B <= 65535 or min(H, W, C) < 1 or B * H * W * C >= 2 ** 62:
        raise ValueError("fused_bottleneck: x of shape %s is outside the "
                         "kernel's grid" % (tuple(x.shape),))
    return B, H, W, C, M


def fused_bottleneck(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """One bottleneck unit (see the module docstring); returns a new
    (B, H, W, C) tensor of x's dtype."""
    args = (x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    if all(t.device.type == "cpu" for t in args):
        return bottleneck_reference(*args)
    if x.device.type != "cuda":
        raise ValueError("fused_bottleneck: unsupported device %s"
                         % x.device)
    B, H, W, C, M = _check_cuda(*args)
    out = torch.empty_like(x)
    dev = x.device
    route = _route(x.dtype, C, M, [t.data_ptr() for t in (x, w1, w2, w3,
                                                            out)])
    rc = _build.library().mxtpu_fused_bottleneck(
        *(t.data_ptr() for t in args), out.data_ptr(), B, H, W, C, M,
        ROUTES[route], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_bottleneck")
    _build.count_launch(fused_bottleneck)
    return out


fused_bottleneck.launches = 0
