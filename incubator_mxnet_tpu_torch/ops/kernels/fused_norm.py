"""LayerNorm and row softmax over the last axis: the CUDA kernels' wrappers,
their plain PyTorch versions, and their gradients.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/fused_norm.py``. The
forward kernels are in ``csrc/fused_norm.cu``. The JAX package's backwards
(``_ln_bwd``, ``_softmax_bwd``) are plain jnp, not Pallas kernels, so here
they are plain PyTorch, written as they are, in ``torch.autograd.Function``s
around the forward kernels.

A wrapper takes the plain version for a tensor on the CPU, and only then.
For a CUDA tensor it launches its kernel or raises: float32, bfloat16 or
float16 (x, gamma and beta of one dtype, as the JAX package's
compute_dtype cast leaves them), contiguous, any row count. Each dtype has
its own kernel and its own launch count: ``layer_norm`` and ``softmax``
count the fp32 kernels and route a bf16 tensor to ``layer_norm_bf16`` /
``softmax_bf16`` and an fp16 one to ``layer_norm_f16`` / ``softmax_f16``,
which count theirs. A 16-bit CUDA tensor launches its kernel or raises:
there is no fallback and no cast to fp32. The 16-bit kernels compute in
fp32 and round the output once; in fp16 a value past 65504 rounds to inf
and a small one to a subnormal, as jnp's ``astype`` gives them. Inputs
that need no gradient skip the autograd Function.

``_route`` picks the LayerNorm kernel's route from the row length, the
element size and the four tensors' addresses: ``"warp"`` (a warp a row,
16-byte accesses) for C <= 1024 with C a multiple of a 16-byte vector (4
floats, 8 bf16 or fp16) and 16-byte aligned bases, ``"warp_scalar"`` for
the other rows of up to 1024, ``"long"`` (a block a row) above 1024. The C
entry refuses a route whose conditions fail.

``_softmax_route`` does the same for the 16-bit softmax entries:
``"vec"`` (a group of lanes a row, 16-byte vectors of 8 values, several
rows in flight a lane) for C <= 1024 with C a multiple of 8 and x and the
output 16-byte aligned, ``"scalar"`` (a warp a row, a value a lane) for the
other rows of up to 1024, ``"long"`` above 1024. fp32 has no ``vec``
kernel: its entry takes no route and runs ``scalar`` or ``long`` by C.
"""

import torch

from ...telemetry import costs as _costs
from . import _build

__all__ = ["layer_norm", "softmax", "layer_norm_bf16", "softmax_bf16",
           "layer_norm_f16", "softmax_f16", "layer_norm_reference",
           "softmax_reference", "ROUTES", "SOFTMAX_ROUTES"]

_INT_MAX = 2 ** 31 - 1

#: the C entry's LayerNorm route codes
ROUTES = {"warp": 0, "warp_scalar": 1, "long": 2}
#: the C entries' 16-bit softmax route codes
SOFTMAX_ROUTES = {"vec": 0, "scalar": 1, "long": 2}
#: the longest row of the warp routes (one row in a warp's registers)
MAX_WARP_C = 1024


def _route(C, x_ptr, g_ptr, b_ptr, y_ptr, elem_bytes=4):
    """The LayerNorm kernel's route for rows of ``C`` elements of
    ``elem_bytes`` bytes whose x, gamma, beta and output start at those
    byte addresses."""
    if C > MAX_WARP_C:
        return "long"
    vec = C % (16 // elem_bytes) == 0 and all(
        p % 16 == 0 for p in (x_ptr, g_ptr, b_ptr, y_ptr))
    return "warp" if vec else "warp_scalar"


def _softmax_route(C, x_ptr, y_ptr, elem_bytes):
    """The softmax kernel's route for rows of ``C`` elements of
    ``elem_bytes`` bytes whose input and output start at those byte
    addresses (``vec`` only for 2-byte elements)."""
    if C > MAX_WARP_C:
        return "long"
    vec = elem_bytes == 2 and C % 8 == 0 and x_ptr % 16 == 0 \
        and y_ptr % 16 == 0
    return "vec" if vec else "scalar"


def layer_norm_reference(x, gamma, beta, eps=1e-5):
    """Plain LayerNorm over the last axis with the kernel's arithmetic:
    fp32 mean, then the centred variance, then
    (x - mean) * rsqrt(var + eps) * gamma + beta, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xc * inv * gamma.float() + beta.float()).to(x.dtype)


def softmax_reference(x):
    """Plain softmax over the last axis with the kernel's arithmetic: fp32
    max, exp(x - max), sum, divide. A row that is all -inf gives NaN, as
    ``jax.nn.softmax`` does."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


#: the dtypes with a CUDA kernel
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_cuda(what, *tensors):
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError("%s: tensors on %s and %s" % (what, dev, t.device))
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError("%s: the CUDA kernels take float32, bfloat16 "
                            "or float16, got %s" % (what, t.dtype))
        if t.dtype != dt:
            raise TypeError("%s: tensors of %s and %s; the kernel takes one "
                            "dtype" % (what, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: the CUDA kernel takes contiguous tensors"
                             % what)


def _rows(what, x):
    if x.dim() == 0:
        raise ValueError("%s: needs at least one axis" % what)
    C = x.shape[-1]
    rows = x.numel() // C if C else 0
    if rows > _INT_MAX or C > _INT_MAX:
        raise ValueError("%s: %d rows of %d exceed the kernel's int range"
                         % (what, rows, C))
    return rows, C


def _layer_norm_launch(what, entry, wrapper, x, gamma, beta, eps):
    """One launch of a LayerNorm kernel (C entry ``entry``) on CUDA tensors
    of one dtype, counted on ``wrapper``."""
    _check_cuda(what, x, gamma, beta)
    rows, C = _rows(what, x)
    if tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,):
        raise ValueError("%s: gamma %s and beta %s must be (%d,)"
                         % (what, tuple(gamma.shape), tuple(beta.shape), C))
    out = torch.empty_like(x)
    if rows == 0 or C == 0:
        return out
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    esize = x.element_size()
    rc = getattr(_build.library(), entry)(
        *ptrs, rows, C, float(eps), ROUTES[_route(C, *ptrs, esize)],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, what)
    _build.count_launch(wrapper,
                        lambda: _costs.rows_cost(rows, C, 2, esize))
    return out


def _half_launch(launch, wrapper, dtype, x, *args):
    """A 16-bit kernel's wrapper: CUDA tensors of ``dtype`` only; the C
    entry is ``mxtpu_`` and the wrapper's name."""
    what = wrapper.__name__
    if x.device.type != "cuda" or x.dtype != dtype:
        raise TypeError("%s: takes %s CUDA tensors, got %s on %s"
                        % (what, str(dtype)[6:], x.dtype, x.device))
    return launch(what, "mxtpu_" + what, wrapper, x, *args)


def layer_norm_bf16(x, gamma, beta, eps=1e-5):
    """The bf16 LayerNorm kernel on CUDA tensors: x, gamma and beta all
    bfloat16, contiguous; fp32 arithmetic, the output rounded to bf16 once.
    Returns y (bf16). Not differentiable by itself: ``layer_norm`` is."""
    return _half_launch(_layer_norm_launch, layer_norm_bf16, torch.bfloat16,
                        x, gamma, beta, eps)


layer_norm_bf16.launches = 0


def layer_norm_f16(x, gamma, beta, eps=1e-5):
    """The fp16 LayerNorm kernel on CUDA tensors: x, gamma and beta all
    float16, contiguous; fp32 arithmetic, the output rounded to fp16 once
    (inf past 65504). Returns y (fp16). Not differentiable by itself:
    ``layer_norm`` is."""
    return _half_launch(_layer_norm_launch, layer_norm_f16, torch.float16,
                        x, gamma, beta, eps)


layer_norm_f16.launches = 0
#: the 16-bit LayerNorm kernels by input dtype
_HALF_LN = {torch.bfloat16: layer_norm_bf16, torch.float16: layer_norm_f16}


def _layer_norm_forward(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm: unsupported device %s" % x.device)
    if x.dtype in _HALF_LN:
        return _HALF_LN[x.dtype](x, gamma, beta, eps)
    return _layer_norm_launch("layer_norm", "mxtpu_layer_norm_f32",
                              layer_norm, x, gamma, beta, eps)


def _ln_backward(x, gamma, g, eps):
    """``_ln_bwd``: mean and rstd recomputed in fp32; (dx, dgamma, dbeta)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    gf = g.reshape(-1, C).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    dgamma = (gf * xhat).sum(dim=0).to(gamma.dtype)
    dbeta = gf.sum(dim=0).to(gamma.dtype)
    dy = gf * gamma.float()
    dx = inv / C * (C * dy - dy.sum(dim=-1, keepdim=True)
                    - xhat * (dy * xhat).sum(dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _layer_norm_forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _ln_backward(x, gamma, g, ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x``; gamma and beta are (C,).
    Differentiable in all three."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, gamma, beta)):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _layer_norm_forward(x, gamma, beta, eps)


layer_norm.launches = 0


def _softmax_launch(what, entry, wrapper, x):
    """One launch of a softmax kernel (C entry ``entry``), counted on
    ``wrapper``."""
    _check_cuda(what, x)
    rows, C = _rows(what, x)
    out = torch.empty_like(x)
    if rows == 0 or C == 0:
        return out
    ptrs = (x.data_ptr(), out.data_ptr())
    esize = x.element_size()
    # the 16-bit entries take the route; fp32's picks its kernel from C
    route = () if esize == 4 else (
        SOFTMAX_ROUTES[_softmax_route(C, *ptrs, esize)],)
    rc = getattr(_build.library(), entry)(
        *ptrs, rows, C, *route, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, what)
    _build.count_launch(wrapper,
                        lambda: _costs.rows_cost(rows, C, 0, esize))
    return out


def softmax_bf16(x):
    """The bf16 softmax kernel on a contiguous bfloat16 CUDA tensor: fp32
    arithmetic, the output rounded to bf16 once. Not differentiable by
    itself: ``softmax`` is."""
    return _half_launch(_softmax_launch, softmax_bf16, torch.bfloat16, x)


softmax_bf16.launches = 0


def softmax_f16(x):
    """The fp16 softmax kernel on a contiguous float16 CUDA tensor: fp32
    arithmetic, the output rounded to fp16 once (a probability below 2**-14
    a subnormal). Not differentiable by itself: ``softmax`` is."""
    return _half_launch(_softmax_launch, softmax_f16, torch.float16, x)


softmax_f16.launches = 0
#: the 16-bit softmax kernels by input dtype
_HALF_SOFTMAX = {torch.bfloat16: softmax_bf16, torch.float16: softmax_f16}


def _softmax_forward(x):
    if x.device.type == "cpu":
        return softmax_reference(x)
    if x.device.type != "cuda":
        raise ValueError("softmax: unsupported device %s" % x.device)
    if x.dtype in _HALF_SOFTMAX:
        return _HALF_SOFTMAX[x.dtype](x)
    return _softmax_launch("softmax", "mxtpu_softmax_f32", softmax, x)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _softmax_forward(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _softmax_bwd: y * (g - sum(g * y)) in fp32
        (y,) = ctx.saved_tensors
        yf, gf = y.float(), g.float()
        dx = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
        return dx.to(y.dtype)


def softmax(x):
    """Softmax over the last axis of ``x``; differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Softmax.apply(x)
    return _softmax_forward(x)


softmax.launches = 0
