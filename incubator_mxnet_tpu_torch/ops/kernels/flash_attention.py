"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/flash_attention.py``. The
forward kernel is in ``csrc/flash_attention_fwd.cu``, the dQ and dK/dV
kernels in ``csrc/flash_attention_bwd.cu``. They take any T; the JAX
package's ``T % 128`` rule was the TPU's tiling and does not apply.

``flash_attention_forward`` works on (B*H, T, D) and returns ``(out, lse)``
with lse as (B*H, T); ``flash_attention_backward`` takes the forward's
inputs, ``out``, ``lse`` and the output's cotangent and returns
``(dq, dk, dv)``, recomputing P from the lse, and with ``needs_dbias`` also
the per-key bias's cotangent, (B*H, T). For CPU tensors they take the plain
versions; for CUDA tensors they launch the kernels or raise, and each
kernel's wrapper adds one to its ``launches`` count: the dK/dV kernel
without dbias counts on ``flash_attention_bwd_dkv``, with it on
``flash_attention_bwd_dkv_dbias``. ``flash_attention`` is the public
(B, H, T, D) API of the JAX package, differentiable through
``torch.autograd`` in q, k, v and a learned ``kv_bias`` (the TPU kernel's
``has_dbias`` path); its padding mask is a constant, as in the JAX package,
and costs no dbias.

Each kernel has an fp32, a bf16 and an fp16 flavour, as the TPU kernels
take the input dtype: q, k, v (and do) of one dtype, the key bias and the
lse fp32. ``flash_attention_forward`` and ``flash_attention_backward`` route
by dtype; the bf16 kernels count on ``flash_attention_fwd_bf16``,
``flash_attention_bwd_dq_bf16``, ``flash_attention_bwd_dkv_bf16`` and, with
a learned bias's cotangent, ``flash_attention_bwd_dkv_dbias_bf16``; the fp16
ones on ``flash_attention_fwd_f16``, ``flash_attention_bwd_dq_f16``,
``flash_attention_bwd_dkv_f16`` and ``flash_attention_bwd_dkv_dbias_f16``.
A 16-bit CUDA tensor launches them or raises (no cast to fp32). The 16-bit
dQ kernels take the forward's ``out`` where the fp32 one takes delta =
rowsum(dO * O): they compute delta for their own rows and return ``(dq,
delta)``, and the dK/dV kernels read that delta. The plain versions round
where the TPU kernels round: p to the input dtype before P V and dS before
dS K and dS^T Q (a no-op for fp32), with every product taken in fp32 from
the rounded values; dbias stays the fp32 sum of the unrounded, unscaled dS.
In fp16 a rounded dS past 65504 is inf, in the kernels as in the plain
versions (``.to(torch.float16)``), so a loss scale that overflows shows in
dq, dk and dv.
"""

import torch

from ...telemetry import costs as _costs
from . import _build

__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_reference", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_dbias",
           "flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
           "flash_attention_bwd_dkv_bf16",
           "flash_attention_bwd_dkv_dbias_bf16", "flash_attention_fwd_f16",
           "flash_attention_bwd_dq_f16", "flash_attention_bwd_dkv_f16",
           "flash_attention_bwd_dkv_dbias_f16"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
#: the input dtypes with CUDA kernels
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the 16-bit kernels' C entry suffix by input dtype
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _rounded(x, dtype):
    """``x`` rounded to a low-precision input ``dtype`` and back, where the
    TPU kernels feed their second products in the input dtype; float32 and
    float64 inputs pass through unchanged."""
    if dtype in (torch.float32, torch.float64):
        return x
    return x.to(dtype).to(x.dtype)


def flash_attention_reference(q, k, v, bias=None, scale=1.0, causal=False):
    """Plain attention on (BH, T, D) with the kernel's semantics: scores
    scaled, plus the per-key ``bias`` (BH, T), causal scores above the
    diagonal set to -1e30, softmax through max / exp / sum, and rows whose
    max stays at or below -0.5e30 (every key masked) set to exact 0 with
    lse 0. Returns ``(out, lse)``. In bf16 or fp16, as the TPU kernel: both
    products in fp32 from the 16-bit values, p rounded to the input dtype
    before P V, the sum l and the lse from the unrounded p."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[:, None, :]
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], _NEG_INF)
    m = s.amax(dim=-1).clamp_min(_NEG_INF)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.matmul(_rounded(p, v.dtype), v.float()) / l_safe[..., None]
    dead = m <= _NEG_INF * 0.5
    out = out.masked_fill(dead[..., None], 0.0)
    lse = (m + torch.log(l_safe)).masked_fill(dead, 0.0)
    return out.to(q.dtype), lse


def _check_cuda(q, k, v, bias, dtype=None):
    """Device, dtype, shape, contiguity and alignment of a kernel's inputs;
    ``dtype`` is the one its kernel takes (None: either kernel dtype)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention: %s on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dtype not in _KERNEL_DTYPES or t.dtype != q.dtype \
                or (dtype is not None and t.dtype != dtype):
            raise TypeError("flash_attention: the CUDA kernels take q, k, v "
                            "of one dtype, float32, bfloat16 or float16%s; "
                            "%s is %s" % ("" if dtype is None else
                                          " (this one %s)" % dtype, name,
                                          t.dtype))
        if t.dim() != 3 or t.shape != q.shape:
            raise ValueError("flash_attention: q, k, v must share one "
                             "(BH, T, D) shape, got %s" % (tuple(t.shape),))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: %s must be contiguous and "
                             "16-byte aligned" % name)
    bh, T, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError("flash_attention: head dim %d not in %s"
                         % (D, _HEAD_DIMS))
    if bh > 65535:
        raise ValueError("flash_attention: B*H = %d exceeds 65535" % bh)
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32 \
                or tuple(bias.shape) != (bh, T) or not bias.is_contiguous():
            raise ValueError("flash_attention: bias must be a contiguous "
                             "float32 (%d, %d) tensor on %s"
                             % (bh, T, q.device))


def _forward_cost(bh, T, D, bias, causal, elem_bytes=4):
    """(flops, bytes) of one forward launch: both products over every key
    (half of them under a causal mask), as the plain version counts, and
    the bytes of the kernel's bound with the per-key bias read once."""
    nbytes, _live, dense = _costs.flash_forward_cost(bh, T, D, [T],
                                                     elem_bytes)
    if bias is not None:
        nbytes += bh * T * 4
    return (dense / 2 if causal else dense), nbytes


def _forward_launch(entry, wrapper, q, k, v, bias, scale, causal):
    """One launch of a forward kernel (C entry ``entry``), counted on
    ``wrapper``. Returns ``(out, lse)``."""
    bh, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, T), dtype=torch.float32, device=q.device)
    if bh == 0 or T == 0:
        return out, lse
    rc = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), bh, T, D, float(scale),
        int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, wrapper.__name__)
    esize = q.element_size()
    _build.count_launch(wrapper, lambda: _forward_cost(bh, T, D, bias, causal,
                                                       esize))
    return out, lse


def flash_attention_forward(q, k, v, bias=None, scale=None, causal=False):
    """Attention forward on (BH, T, D); ``bias`` is an additive per-key
    (BH, T) float32 tensor or None. Returns ``(out, lse)``: out in q's
    dtype, lse float32. CUDA tensors of bfloat16 go to
    ``flash_attention_fwd_bf16``, of float16 to ``flash_attention_fwd_f16``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: unsupported device %s" % q.device)
    if q.dtype in _HALF_FWD:
        return _HALF_FWD[q.dtype](q, k, v, bias, scale, causal)
    _check_cuda(q, k, v, bias, torch.float32)
    return _forward_launch("mxtpu_flash_attention_fwd_f32",
                           flash_attention_forward, q, k, v, bias, scale,
                           causal)


flash_attention_forward.launches = 0


def _forward16(wrapper, dtype, q, k, v, bias, scale, causal):
    """A 16-bit forward kernel's launch, counted on ``wrapper``. Refuses
    what ``_check_cuda`` refuses (dtypes, shapes, head dim, contiguity,
    alignment, the bias), then tensors that do not lie on a CUDA card,
    before the library is built or reached."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check_cuda(q, k, v, bias, dtype)
    if q.device.type != "cuda":
        raise ValueError("%s: takes CUDA tensors, got %s"
                         % (wrapper.__name__, q.device))
    return _forward_launch("mxtpu_flash_attention_fwd_" + _SUFFIX[dtype],
                           wrapper, q, k, v, bias, scale, causal)


def flash_attention_fwd_bf16(q, k, v, bias=None, scale=None, causal=False):
    """The bf16 forward kernel on CUDA tensors: (BH, T, D) bfloat16 q, k, v,
    an fp32 (BH, T) bias or None. Returns ``(out, lse)``, out bf16 and lse
    fp32."""
    return _forward16(flash_attention_fwd_bf16, torch.bfloat16, q, k, v,
                      bias, scale, causal)


flash_attention_fwd_bf16.launches = 0


def flash_attention_fwd_f16(q, k, v, bias=None, scale=None, causal=False):
    """The fp16 forward kernel on CUDA tensors: (BH, T, D) float16 q, k, v,
    an fp32 (BH, T) bias or None (a -1e30 mask stays finite there). Returns
    ``(out, lse)``, out fp16 and lse fp32."""
    return _forward16(flash_attention_fwd_f16, torch.float16, q, k, v, bias,
                      scale, causal)


flash_attention_fwd_f16.launches = 0
#: the 16-bit forward kernels by input dtype
_HALF_FWD = {torch.bfloat16: flash_attention_fwd_bf16,
             torch.float16: flash_attention_fwd_f16}


def flash_attention_backward_reference(q, k, v, out, lse, do, bias=None,
                                       scale=1.0, causal=False,
                                       needs_dbias=False,
                                       compute_dtype=torch.float32):
    """Plain attention backward on (BH, T, D) as the TPU kernels compute it
    (``_recompute_p_ds``): P = exp(s - lse) from the forward's lse, with s
    the scaled, biased and causally masked scores; delta = rowsum(dO * O);
    dS = P * (dP - delta) * scale. Returns ``(dq, dk, dv)``, and with
    ``needs_dbias`` also dbias = the sum over query rows of P * (dP -
    delta), (BH, T). A row whose keys are all masked (lse 0, out 0) gives
    P = 0 and so no gradient; so does a masked key.

    The formulas run in ``compute_dtype``: float32 (the default) returns
    the gradients in the inputs' dtypes and dbias in float32; float64
    evaluates the same formulas on the same inputs in float64 and returns
    float64, the oracle that the CUDA kernels are held to on the card. For
    bf16 or fp16 inputs p and dS are rounded to the input dtype before the
    second products, as the TPU kernels round them (``_recompute_p_ds``; in
    fp16 a dS past 65504 becomes inf), and delta is taken in fp32 from the
    16-bit dO and O; dbias stays the unrounded sum."""
    cd = compute_dtype
    qf, kf, vf, dof = q.to(cd), k.to(cd), v.to(cd), do.to(cd)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(cd)[:, None, :]
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], _NEG_INF)
    p = torch.exp(s - lse.to(cd)[..., None])
    delta = (dof * out.to(cd)).sum(dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds_bias = p * (dp - delta[..., None])
    ds = ds_bias * scale
    ds_r, p_r = _rounded(ds, v.dtype), _rounded(p, v.dtype)
    dq = torch.matmul(ds_r, kf)
    dk = torch.matmul(ds_r.transpose(-1, -2), qf)
    dv = torch.matmul(p_r.transpose(-1, -2), dof)
    grads = (dq, dk, dv)
    if cd == torch.float32:
        grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if needs_dbias:
        grads += (ds_bias.sum(dim=-2),)
    return grads


def _check_bwd_cuda(q, k, v, do, lse, delta, bias, dtype, out=None):
    """A backward kernel's inputs: q, k, v and the bias as the forward's,
    ``do`` (and ``out``, for the 16-bit dQ kernels, which take it in
    delta's place: pass ``delta=None``) of q's dtype and shape, lse (and
    delta) contiguous float32 (BH, T), all on one CUDA device. A missing
    tensor is refused as a wrong one is."""
    _check_cuda(q, k, v, bias, dtype)
    bh, T, _D = q.shape
    for name, t in (("do", do),) + ((("out", out),) if delta is None
                                    else ()):
        if t is None or t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention backward: %s must be a "
                             "contiguous, 16-byte aligned %s %s tensor on %s"
                             % (name, q.dtype, tuple(q.shape), q.device))
    for name, t in (("lse", lse),) + ((("delta", delta),) if delta is not None
                                      else ()):
        if t is None or t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (bh, T) or not t.is_contiguous():
            raise ValueError("flash_attention backward: %s must be a "
                             "contiguous float32 (%d, %d) tensor on %s"
                             % (name, bh, T, q.device))
    if q.device.type != "cuda":
        raise ValueError("flash_attention backward: the kernels take CUDA "
                         "tensors, got %s" % q.device)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_bwd_dq(q, k, v, do, lse, delta, bias, scale, causal):
    """The dQ kernel on CUDA tensors: (BH, T, D) q, k, v, do; (BH, T) lse
    and delta = rowsum(dO * O); bias (BH, T) or None. Returns dq."""
    _check_bwd_cuda(q, k, v, do, lse, delta, bias, torch.float32)
    bh, T, D = q.shape
    dq = torch.empty_like(q)
    if bh == 0 or T == 0:
        return dq
    rc = _build.library().mxtpu_flash_attention_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if bias is None else bias.data_ptr(), dq.data_ptr(),
        bh, T, D, float(scale), int(bool(causal)), q.device.index,
        _stream(q))
    _build.check(rc, "flash_attention_bwd_dq")
    _build.count_launch(flash_attention_bwd_dq)
    return dq


flash_attention_bwd_dq.launches = 0


def _dkv(what, wrapper, q, k, v, do, lse, delta, bias, scale, causal,
         dbias):
    """One launch of the dK/dV kernel, with the dbias output when ``dbias``;
    counted on ``wrapper``. Returns ``(dk, dv[, dbias])``."""
    _check_bwd_cuda(q, k, v, do, lse, delta, bias, torch.float32)
    bh, T, D = q.shape
    outs = (torch.empty_like(k), torch.empty_like(v))
    if dbias:
        outs += (torch.empty((bh, T), dtype=torch.float32, device=q.device),)
    if bh == 0 or T == 0:
        return outs
    rc = _build.library().mxtpu_flash_attention_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if bias is None else bias.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr() if dbias else None, bh, T, D,
        float(scale), int(bool(causal)), q.device.index, _stream(q))
    _build.check(rc, what)
    _build.count_launch(wrapper)
    return outs


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias, scale, causal):
    """The dK/dV kernel on CUDA tensors, with the dQ kernel's arguments.
    Returns ``(dk, dv)``."""
    return _dkv("flash_attention_bwd_dkv", flash_attention_bwd_dkv, q, k, v,
                do, lse, delta, bias, scale, causal, False)


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dkv_dbias(q, k, v, do, lse, delta, bias, scale,
                                  causal):
    """The dK/dV kernel with the per-key bias's cotangent (the TPU kernel's
    ``has_dbias`` variant), with the dQ kernel's arguments. Returns ``(dk,
    dv, dbias)``, dbias (BH, T) float32."""
    return _dkv("flash_attention_bwd_dkv_dbias",
                flash_attention_bwd_dkv_dbias, q, k, v, do, lse, delta, bias,
                scale, causal, True)


flash_attention_bwd_dkv_dbias.launches = 0


def _backward_cost(bh, T, D, bias, causal, n_prod, n_out, elem_bytes,
                   dbias=False, reads_out=False):
    """(flops, bytes) of one backward launch: ``n_prod`` T x T x D products
    over every key (half under a causal mask); q, k, v and do read, lse and
    delta (and the bias) read, ``n_out`` (BH, T, D) outputs written, and
    the fp32 (BH, T) dbias with ``dbias``. With ``reads_out`` (the 16-bit
    dQ kernels) the forward's out is read too, and delta is written rather
    than read: the same (BH, T) floats."""
    flops = 2.0 * n_prod * bh * T * T * D / (2 if causal else 1)
    nbytes = ((4 + n_out + bool(reads_out)) * bh * T * D * elem_bytes
              + (2 + (bias is not None) + bool(dbias)) * bh * T * 4)
    return flops, float(nbytes)


def _dq16(wrapper, dtype, q, k, v, do, out, lse, bias, scale, causal):
    """One launch of a 16-bit dQ kernel, counted on ``wrapper``. Returns
    ``(dq, delta)``."""
    _check_bwd_cuda(q, k, v, do, lse, None, bias, dtype, out)
    bh, T, D = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((bh, T), dtype=torch.float32, device=q.device)
    if bh == 0 or T == 0:
        return dq, delta
    rc = getattr(_build.library(),
                 "mxtpu_flash_attention_bwd_dq_" + _SUFFIX[dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        None if bias is None else bias.data_ptr(), dq.data_ptr(),
        delta.data_ptr(), bh, T, D, float(scale), int(bool(causal)),
        q.device.index, _stream(q))
    _build.check(rc, wrapper.__name__)
    _build.count_launch(wrapper,
                        lambda: _backward_cost(bh, T, D, bias, causal, 3, 1,
                                               2, reads_out=True))
    return dq, delta


def flash_attention_bwd_dq_bf16(q, k, v, do, out, lse, bias, scale,
                                causal):
    """The bf16 dQ kernel on CUDA tensors: (BH, T, D) bfloat16 q, k, v, do
    and the forward's out; fp32 (BH, T) lse, and bias or None. Returns
    ``(dq, delta)``: dq bf16, and delta = rowsum(dO * O) in fp32, (BH, T),
    which the kernel takes for its own rows and the dK/dV kernel reads."""
    return _dq16(flash_attention_bwd_dq_bf16, torch.bfloat16, q, k, v, do,
                 out, lse, bias, scale, causal)


flash_attention_bwd_dq_bf16.launches = 0


def flash_attention_bwd_dq_f16(q, k, v, do, out, lse, bias, scale,
                               causal):
    """The fp16 dQ kernel on CUDA tensors: (BH, T, D) float16 q, k, v, do (a
    scaled dO under dynamic loss scaling) and the forward's out; fp32 (BH,
    T) lse, and bias or None. Returns ``(dq, delta)``: dq fp16 (inf where a
    scaled dS or sum overflows), and delta = rowsum(dO * O) in fp32, (BH,
    T)."""
    return _dq16(flash_attention_bwd_dq_f16, torch.float16, q, k, v, do,
                 out, lse, bias, scale, causal)


flash_attention_bwd_dq_f16.launches = 0


def _dkv16(wrapper, dtype, q, k, v, do, lse, delta, bias, scale, causal,
           dbias):
    """One launch of a 16-bit dK/dV kernel, with the fp32 dbias output when
    ``dbias``; counted on ``wrapper``. Returns ``(dk, dv[, dbias])``."""
    _check_bwd_cuda(q, k, v, do, lse, delta, bias, dtype)
    bh, T, D = q.shape
    outs = (torch.empty_like(k), torch.empty_like(v))
    if dbias:
        outs += (torch.empty((bh, T), dtype=torch.float32, device=q.device),)
    if bh == 0 or T == 0:
        return outs
    rc = getattr(_build.library(),
                 "mxtpu_flash_attention_bwd_dkv_" + _SUFFIX[dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if bias is None else bias.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr() if dbias else None, bh, T, D,
        float(scale), int(bool(causal)), q.device.index, _stream(q))
    _build.check(rc, wrapper.__name__)
    _build.count_launch(wrapper, lambda: _backward_cost(
        bh, T, D, bias, causal, 4, 2, 2, dbias))
    return outs


def flash_attention_bwd_dkv_bf16(q, k, v, do, lse, delta, bias, scale,
                                 causal):
    """The bf16 dK/dV kernel (without dbias) on CUDA tensors: (BH, T, D)
    bfloat16 q, k, v, do; fp32 (BH, T) lse, delta (the bf16 dQ kernel's),
    and bias or None. Returns ``(dk, dv)`` (bf16)."""
    return _dkv16(flash_attention_bwd_dkv_bf16, torch.bfloat16, q, k, v, do,
                  lse, delta, bias, scale, causal, False)


flash_attention_bwd_dkv_bf16.launches = 0


def flash_attention_bwd_dkv_dbias_bf16(q, k, v, do, lse, delta, bias, scale,
                                       causal):
    """The bf16 dK/dV kernel with the per-key bias's cotangent (the TPU
    kernel's ``has_dbias`` variant on bf16 inputs), with the bf16 dK/dV
    kernel's arguments. Returns ``(dk, dv, dbias)``: dk and dv bf16 from dS
    rounded to bf16, dbias (BH, T) fp32, the sum over query rows of the
    unrounded, unscaled dS."""
    return _dkv16(flash_attention_bwd_dkv_dbias_bf16, torch.bfloat16, q, k,
                  v, do, lse, delta, bias, scale, causal, True)


flash_attention_bwd_dkv_dbias_bf16.launches = 0


def flash_attention_bwd_dkv_f16(q, k, v, do, lse, delta, bias, scale,
                                causal):
    """The fp16 dK/dV kernel (without dbias) on CUDA tensors: (BH, T, D)
    float16 q, k, v, do; fp32 (BH, T) lse, delta (the fp16 dQ kernel's), and
    bias or None. Returns ``(dk, dv)`` (fp16)."""
    return _dkv16(flash_attention_bwd_dkv_f16, torch.float16, q, k, v, do,
                  lse, delta, bias, scale, causal, False)


flash_attention_bwd_dkv_f16.launches = 0


def flash_attention_bwd_dkv_dbias_f16(q, k, v, do, lse, delta, bias, scale,
                                      causal):
    """The fp16 dK/dV kernel with the per-key bias's cotangent (the TPU
    kernel's ``has_dbias`` variant on fp16 inputs), with the fp16 dK/dV
    kernel's arguments. Returns ``(dk, dv, dbias)``: dk and dv fp16 from dS
    rounded to fp16 (inf where a scaled dS overflows), dbias (BH, T) fp32,
    the sum over query rows of the unrounded, unscaled dS."""
    return _dkv16(flash_attention_bwd_dkv_dbias_f16, torch.float16, q, k, v,
                  do, lse, delta, bias, scale, causal, True)


flash_attention_bwd_dkv_dbias_f16.launches = 0
#: the 16-bit backward kernels by input dtype: (dQ, dK/dV, dK/dV with
#: dbias)
_HALF_BWD = {
    torch.bfloat16: (flash_attention_bwd_dq_bf16,
                     flash_attention_bwd_dkv_bf16,
                     flash_attention_bwd_dkv_dbias_bf16),
    torch.float16: (flash_attention_bwd_dq_f16, flash_attention_bwd_dkv_f16,
                    flash_attention_bwd_dkv_dbias_f16)}


def flash_attention_backward(q, k, v, out, lse, do, bias=None, scale=None,
                             causal=False, needs_dbias=False):
    """Gradients of attention on (BH, T, D) from the forward's ``out`` and
    ``lse`` and the output's cotangent ``do``: ``(dq, dk, dv)``, and with
    ``needs_dbias`` the per-key bias's cotangent (BH, T) after them, from
    the dK/dV kernel's dbias variant. Without it the bias (a padding mask)
    gets no gradient and costs none. bf16 and fp16 CUDA tensors go to
    their dtype's kernels, dbias included."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  bias, scale, causal,
                                                  needs_dbias)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: unsupported device %s" % q.device)
    if q.dtype in _HALF_BWD:
        dq_fn, dkv_fn, dbias_fn = _HALF_BWD[q.dtype]
        if needs_dbias:
            dkv_fn = dbias_fn
        # the dQ kernel takes delta = rowsum(dO * O) in fp32 from the
        # 16-bit tensors, as _bwd_call does, and hands it to dK/dV
        dq, delta = dq_fn(q, k, v, do, out, lse, bias, scale, causal)
        return (dq,) + dkv_fn(q, k, v, do, lse, delta, bias, scale, causal)
    # delta = rowsum(dO * O): one reduction, as in the TPU kernel's caller
    delta = (do * out).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, bias, scale, causal)
    dkv = flash_attention_bwd_dkv_dbias if needs_dbias \
        else flash_attention_bwd_dkv
    return (dq,) + tuple(dkv(q, k, v, do, lse, delta, bias, scale, causal))


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention_forward``, backward through
    ``flash_attention_backward`` from the saved (q, k, v, bias, out, lse),
    as the JAX package's custom VJP does. The bias gets its cotangent only
    when it needs one (a learned ``kv_bias`` upstream)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        needs_dbias = ctx.needs_input_grad[3]
        grads = flash_attention_backward(
            q, k, v, out, lse, do.contiguous(), bias, ctx.scale, ctx.causal,
            needs_dbias)
        dbias = grads[3] if needs_dbias else None
        return grads[0], grads[1], grads[2], dbias, None, None


def flash_attention(q, k, v, scale=None, causal=False, kv_mask=None,
                    kv_bias=None):
    """q, k, v: (B, H, T, D). Returns (B, H, T, D).

    kv_mask: optional (B, T), nonzero = live key, 0 = padding; padded keys
    get no attention, and a query row whose keys are all masked returns
    exact zeros (and gives zero gradients). kv_bias: optional learned
    additive per-key bias, (B, H, T) or (B, T). Differentiable in q, k, v
    and kv_bias; a masked key's kv_bias gradient is exactly 0. The bias
    tensor stays in the graph only when kv_bias requires grad, so a mask
    alone launches the dK/dV kernel without dbias."""
    B, H, T, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bias = None
    if kv_mask is not None or kv_bias is not None:
        b1 = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
        if kv_bias is not None:
            kb = torch.as_tensor(kv_bias, device=q.device).float()
            if kb.dim() == 2:
                kb = kb[:, None, :]
            b1 = b1 + kb.expand(B, H, T)
        if kv_mask is not None:
            live = torch.as_tensor(kv_mask, device=q.device).reshape(B, T) != 0
            neg = torch.zeros((B, T), dtype=torch.float32, device=q.device)
            b1 = b1 + neg.masked_fill(~live, _NEG_INF)[:, None, :]
        bias = b1.reshape(B * H, T).contiguous()
    q3, k3, v3 = (t.reshape(B * H, T, D).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        out = _FlashAttention.apply(q3, k3, v3, bias, float(scale),
                                    bool(causal))
    else:
        out, _lse = flash_attention_forward(q3, k3, v3, bias, float(scale),
                                            causal)
    return out.reshape(B, H, T, D)
