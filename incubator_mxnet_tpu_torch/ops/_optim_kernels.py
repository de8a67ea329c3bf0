"""Optimizer update rules of the eager gluon path, and the fused seam.

Counterpart of ``incubator_mxnet_tpu/ops/_optim_kernels.py``: the dense
per-parameter rules (``_sgd_update``, ``_sgd_mom_update``, ``_nag_update``,
``_adam_update``, ``_adamw_update``) as plain PyTorch, and the
``_multi_*_update`` seam that updates a whole group of parameters in one
launch of ``ops/kernels/fused_optim.py``'s kernels for CUDA tensors (their
plain versions, these rules applied tensor by tensor, for CPU tensors).

The JAX rules return new arrays; these update ``w`` and the states in place
(the module's forward reads those tensors) and return them. Every
hyper-parameter is rounded to f32 and enters as a 0-dim tensor of the
weight's dtype on the tensors' device, so that each operation is one
correctly rounded operation of that dtype, as in the CUDA kernels (PyTorch
on CUDA divides by a Python scalar through its f32 reciprocal). For bf16
tensors this is what the JAX rules do with their weak-typed Python-float
scalars: each scalar is rounded to bf16 before it meets a tensor, and each
operation rounds its f32 result to bf16. A 0-dim f32 tensor would not do:
on the CPU, torch multiplies a bf16 tensor by it without rounding the
scalar to bf16 first. Adam's ``coef = lr * sqrt(1 - b2**t) / (1 - b1**t)``
and AdamW's ``1 - b1**t``, ``1 - b2**t`` are computed once on the host in
f32 (``adam_coef``, ``adamw_bias``), rounded to the tensors' dtype, and
shared with the kernels. ``clip <= 0`` means no clip; the clip lets a NaN
gradient through.

fp16 tensors take the same rules: each scalar rounded to fp16, each
operation rounded to fp16, which is what the JAX source asks of each
``jnp`` operation and what the CUDA kernels compute. The JAX rules jitted
on a CPU with native fp16 arithmetic (AVX512-FP16) compute something else:
LLVM contracts each fp16 product whose only use is an add or subtract into
one fp16 FMA, rounded once. That is a liberty of XLA's CPU backend, and
PyTorch can express no single-rounded fp16 FMA (its f64 -> fp16 cast rounds
through f32), so the port keeps one rounding per operation; the CPU tests
hold it to the JAX rules within 2 fp16 steps of the largest magnitude among
each element's inputs and outputs (ROADMAP Queue 3 item 14). eps = 1e-8
rounds to 0 in fp16 (its least subnormal is 2**-24), so Adam divides m by
sqrt(v) + 0: NaN where m and v are 0, +-inf where only v is, as the JAX
rules do. fp16 overflows past 65504: Adam's g * g is inf for |g'| > 256.

The lazy / row-sparse rules wait for the sparse NDArray (ROADMAP Queue 1
item 4) and raise.
"""

import functools

import numpy as np
import torch

__all__ = ["_sgd_update", "_sgd_mom_update", "_nag_update", "_adam_update",
           "_adamw_update", "_multi_sgd_mom_update", "_multi_adam_update",
           "_multi_adamw_update", "adam_coef", "adamw_bias", "consts"]

_F32 = torch.float32


@functools.lru_cache(maxsize=256)
def _const(device, dtype, value):
    return torch.tensor(value, dtype=dtype, device=device)


def consts(device, dtype=_F32, **values):
    """{name: 0-dim ``dtype`` tensor on ``device``} of the values rounded
    to f32 and then to ``dtype`` (cached: the rules never write them)."""
    return {k: _const(device, dtype, float(np.float32(v))) for k, v in
            values.items()}


def _host_f32(*values):
    return [torch.tensor(float(np.float32(v)), dtype=_F32) for v in values]


def adam_coef(lr, b1, b2, t):
    """Adam's f32 step size lr * sqrt(1 - b2**t) / (1 - b1**t), computed on
    the host with torch's f32 operations."""
    lr, b1, b2, t, one = _host_f32(lr, b1, b2, t, 1.0)
    return float(lr * torch.sqrt(one - b2 ** t) / (one - b1 ** t))


def adamw_bias(b1, b2, t):
    """AdamW's f32 bias corrections (1 - b1**t, 1 - b2**t), on the host."""
    b1, b2, t, one = _host_f32(b1, b2, t, 1.0)
    return float(one - b1 ** t), float(one - b2 ** t)


def _prologue(g, c, clip):
    g = g * c["rescale"]
    if float(np.float32(clip)) > 0:
        g = torch.clamp(g, -c["clip"], c["clip"])
    return g


def _sgd_update(w, g, lr, wd, rescale, clip):
    """w -= lr * (g' + wd * w), g' the rescaled, clipped gradient."""
    c = consts(w.device, w.dtype, lr=lr, wd=wd, rescale=rescale,
               clip=clip)
    with torch.no_grad():
        g = _prologue(g, c, clip)
        w.sub_(c["lr"] * (g + c["wd"] * w))
    return w


def _sgd_mom_update(w, g, mom, lr, wd, momentum, rescale, clip):
    """mom = momentum * mom - lr * (g' + wd * w); w += mom."""
    c = consts(w.device, w.dtype, lr=lr, wd=wd, momentum=momentum,
               rescale=rescale, clip=clip)
    with torch.no_grad():
        g = _prologue(g, c, clip)
        mom.mul_(c["momentum"]).sub_(c["lr"] * (g + c["wd"] * w))
        w.add_(mom)
    return w, mom


def _nag_update(w, g, mom, lr, wd, momentum, rescale, clip):
    """g'' = g' + wd * w; mom = momentum * mom + g'';
    w -= lr * (momentum * mom + g'')."""
    c = consts(w.device, w.dtype, lr=lr, wd=wd, momentum=momentum,
               rescale=rescale, clip=clip)
    with torch.no_grad():
        g = _prologue(g, c, clip)
        g = g + c["wd"] * w
        mom.mul_(c["momentum"]).add_(g)
        w.sub_(c["lr"] * (c["momentum"] * mom + g))
    return w, mom


def _adam_update(w, g, m, v, lr, wd, b1, b2, eps, t, rescale, clip,
                 coef=None):
    """g'' = g' + wd * w; m, v moved; w -= coef * m / (sqrt(v) + eps)."""
    if coef is None:
        coef = adam_coef(lr, b1, b2, t)
    c = consts(w.device, w.dtype, coef=coef, wd=wd, b1=b1, b2=b2,
               one_minus_b1=1 - np.float32(b1),
               one_minus_b2=1 - np.float32(b2), eps=eps, rescale=rescale,
               clip=clip)
    with torch.no_grad():
        g = _prologue(g, c, clip)
        g = g + c["wd"] * w
        m.mul_(c["b1"]).add_(c["one_minus_b1"] * g)
        v.mul_(c["b2"]).add_(c["one_minus_b2"] * g * g)
        w.sub_(c["coef"] * m / (torch.sqrt(v) + c["eps"]))
    return w, m, v


def _adamw_update(w, g, m, v, lr, wd, eta, b1, b2, eps, t, rescale, clip,
                  bias=None):
    """m, v moved by g'; w -= eta * (lr * mhat / (sqrt(vhat) + eps)
    + wd * w) with mhat = m / (1 - b1**t), vhat = v / (1 - b2**t)."""
    if bias is None:
        bias = adamw_bias(b1, b2, t)
    c = consts(w.device, w.dtype, lr=lr, wd=wd, eta=eta, b1=b1, b2=b2,
               one_minus_b1=1 - np.float32(b1),
               one_minus_b2=1 - np.float32(b2), bias1=bias[0],
               bias2=bias[1], eps=eps, rescale=rescale, clip=clip)
    with torch.no_grad():
        g = _prologue(g, c, clip)
        m.mul_(c["b1"]).add_(c["one_minus_b1"] * g)
        v.mul_(c["b2"]).add_(c["one_minus_b2"] * g * g)
        mhat = m / c["bias1"]
        vhat = v / c["bias2"]
        w.sub_(c["eta"] * (c["lr"] * mhat / (torch.sqrt(vhat) + c["eps"])
                           + c["wd"] * w))
    return w, m, v


def _lazy(name):
    def raise_(*_a, **_k):
        raise NotImplementedError(
            "%s: lazy row-sparse updates wait for the sparse NDArray "
            "(ROADMAP Queue 1 item 4)" % name)
    raise_.__name__ = name
    return raise_


_sgd_lazy_update = _lazy("_sgd_lazy_update")
_sgd_mom_lazy_update = _lazy("_sgd_mom_lazy_update")
_adam_lazy_update = _lazy("_adam_lazy_update")
_adagrad_lazy_update = _lazy("_adagrad_lazy_update")


# ---------------------------------------------------------------------------
# the fused multi-tensor seam: one group, one launch on CUDA
# ---------------------------------------------------------------------------

def _multi_sgd_mom_update(ws, gs, moms, lr, wd, momentum, rescale, clip):
    """One SGD-momentum step over a group, in place; (ws, moms)."""
    from .kernels import fused_optim
    return fused_optim.fused_sgd_mom_flat(ws, gs, moms, lr, wd, momentum,
                                          rescale, clip)


def _multi_adam_update(ws, gs, ms, vs, lr, wd, b1, b2, eps, t, rescale,
                       clip):
    """One Adam step of step number ``t`` over a group, in place;
    (ws, ms, vs)."""
    from .kernels import fused_optim
    return fused_optim.fused_adam_flat(ws, gs, ms, vs, lr, wd, b1, b2, eps,
                                       t, rescale, clip)


def _multi_adamw_update(ws, gs, ms, vs, lr, wd, eta, b1, b2, eps, t, rescale,
                        clip):
    """One AdamW step of step number ``t`` over a group, in place;
    (ws, ms, vs)."""
    from .kernels import fused_optim
    return fused_optim.fused_adamw_flat(ws, gs, ms, vs, lr, wd, eta, b1, b2,
                                        eps, t, rescale, clip)
