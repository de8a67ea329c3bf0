"""Fused optimizer updates: the CUDA kernels' wrappers and their plain
PyTorch versions. ShardedTrainer's Adam / AdamW and SGD with momentum
(``multi_trainer_*``), and the eager gluon Trainer's flat SGD-momentum, Adam
and AdamW with their rescale / clip prologue (``fused_*_flat``).

Counterparts of ``multi_trainer_adam`` (``_trainer_adam_kernel``) and
``multi_trainer_sgd_mom`` (``_sgd_mom_kernel`` with rescale 1 and clip off)
in ``incubator_mxnet_tpu/ops/pallas/fused_optim.py``: the trainer
formulation, no rescale or clip; Adam through mhat / vhat; AdamW adds
``lr*wd * w``; SGD ``mom = momentum * mom - lr * (g + wd * w)``, ``w += mom``.
The kernels are in ``csrc/fused_optim.cu``. The JAX functions return new
arrays; these update the fp32 weights and state in place, so the state is
never packed into one buffer and split again.

The scalars are the f32 values the TPU kernel computes with: lr, wd, b1, b2
and eps rounded from Python floats; ``1 - b1``, ``1 - b2``, ``1 - b1**t`` and
``1 - b2**t`` computed in f32 from those, as the kernel computes them; and
``lr * wd`` rounded once from f64, as the trainer passes it. On the card the
kernel equals ``multi_trainer_adam_reference`` bitwise: the plain version
takes the same scalars as 0-dim tensors on the tensors' device, so that
every division is a true division (PyTorch on CUDA divides by a Python
scalar through its f32 reciprocal) and every operation rounds on its own, as
the kernel's do.

SGD's scalars are lr, wd and momentum rounded to f32, as the TPU kernel's
SMEM row holds them; its plain version takes them the same way.

The eager flavours are counterparts of ``fused_sgd_mom_flat``,
``fused_adam_flat`` and ``fused_adamw_flat`` (``_sgd_mom_kernel``,
``_adam_kernel``, ``_adamw_kernel`` through ``_launch``), reached through the
``ops/_optim_kernels.py`` seam. They take lists of tensors, not one packed
buffer: there are no ``flatten_group`` / ``split_group`` copies. Their plain
versions are the per-parameter rules of ``ops/_optim_kernels.py`` applied
tensor by tensor. SGD shares ``multi_trainer_sgd_mom``'s kernel: the trainer
launches it with rescale 1 and the clip off, where the prologue changes no
bit. Adam's ``coef`` and AdamW's ``1 - b**t`` are computed once on the host
(``adam_coef``, ``adamw_bias``) and passed to both. fp32 is the only dtype
the gluon Trainer sends (``Optimizer._fusable``); the seam also takes bf16
and fp16 lists, as the JAX seam does, and launches the 16-bit flavour of
the same kernel (``mxtpu_flat_*_bf16`` / ``mxtpu_flat_*_f16``, counted on
``fused_*_flat_bf16`` / ``fused_*_flat_f16``): every scalar rounded to the
lists' dtype on the host and every operation rounded to it, so that it
equals the per-parameter rules on such tensors bitwise. A call's lists hold
one dtype; a mix raises ValueError.

For CPU tensors each wrapper takes its plain version; for CUDA tensors it
launches its kernel once for all of them or raises, and adds one to its
``launches`` count.
"""

import os

import numpy as np
import torch

from . import _build
from .. import _optim_kernels as _rules

__all__ = ["multi_trainer_adam", "multi_trainer_adam_reference",
           "multi_trainer_sgd_mom", "multi_trainer_sgd_mom_reference",
           "fused_sgd_mom_flat", "fused_sgd_mom_flat_reference",
           "fused_adam_flat", "fused_adam_flat_reference",
           "fused_adamw_flat", "fused_adamw_flat_reference",
           "fused_sgd_mom_flat_bf16", "fused_adam_flat_bf16",
           "fused_adamw_flat_bf16", "fused_sgd_mom_flat_f16",
           "fused_adam_flat_f16", "fused_adamw_flat_f16", "adam_scalars",
           "sgd_mom_scalars", "fused_optim_enabled"]

CHUNK = 32768          # elements a block updates (csrc/fused_optim.cu kChunk)


def fused_optim_enabled():
    """``MXTPU_FUSED_OPTIM=0`` turns the eager fused path off (the
    optimizers then take their per-parameter rules), as in the JAX
    package."""
    return os.environ.get("MXTPU_FUSED_OPTIM", "1") != "0"


def adam_scalars(lr, wd, b1, b2, eps, t):
    """The f32 scalars of one update at step ``t`` (1-based): {lr, wd, b1,
    b2, one_minus_b1, one_minus_b2, bias1, bias2, eps, lrwd}."""
    f = np.float32
    b1f, b2f, tf = f(b1), f(b2), f(t)
    return dict(lr=f(lr), wd=f(wd), b1=b1f, b2=b2f,
                one_minus_b1=f(1) - b1f, one_minus_b2=f(1) - b2f,
                bias1=f(1) - b1f ** tf, bias2=f(1) - b2f ** tf,
                eps=f(eps), lrwd=f(float(lr) * float(wd)))


def multi_trainer_adam_reference(ws, gs, ms, vs, lr, wd, b1, b2, eps, t,
                                 adamw=False):
    """Plain per-tensor Adam / AdamW in the trainer formulation, in place on
    ``ws``, ``ms`` and ``vs``, with the kernel's scalars and order of
    operations."""
    sc = adam_scalars(lr, wd, b1, b2, eps, t)
    consts = {}
    with torch.no_grad():
        for w, g, m, v in zip(ws, gs, ms, vs):
            if w.device not in consts:
                consts[w.device] = {k: torch.tensor(val, dtype=torch.float32,
                                                    device=w.device)
                                    for k, val in sc.items()}
            c = consts[w.device]
            if not adamw:
                g = g + c["wd"] * w
            m.mul_(c["b1"]).add_(c["one_minus_b1"] * g)
            v.mul_(c["b2"]).add_(c["one_minus_b2"] * g * g)
            mhat = m / c["bias1"]
            vhat = v / c["bias2"]
            upd = (c["lr"] * mhat) / (torch.sqrt(vhat) + c["eps"])
            if adamw:
                upd = upd + c["lrwd"] * w
            w.sub_(upd)
    return ws, ms, vs


def _table(what, groups, dtype=torch.float32):
    """The device table of one launch: a (w, g, state..., n, first chunk)
    row for each tensor of n > 0 elements, and the number of chunks; None
    when every tensor is empty. ``groups`` is ((name, tensors), ...) with
    the weights first; every tensor must be of ``dtype``, contiguous, on
    the weights' device and of its weight's shape."""
    ws = groups[0][1]
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, dev))
    for name, group in groups:
        for i, t in enumerate(group):
            if t.device != dev:
                raise ValueError("%s: %s[%d] on %s, w[0] on %s"
                                 % (what, name, i, t.device, dev))
            if t.dtype != dtype:
                raise TypeError("%s: the CUDA kernel takes %s, %s[%d] is %s"
                                % (what, str(dtype)[6:], name, i, t.dtype))
            if not t.is_contiguous():
                raise ValueError("%s: %s[%d] is not contiguous"
                                 % (what, name, i))
            if t.shape != ws[i].shape:
                raise ValueError("%s: %s[%d] has shape %s, w[%d] %s"
                                 % (what, name, i, tuple(t.shape), i,
                                    tuple(ws[i].shape)))
    rows, chunk0 = [], 0
    for tensors in zip(*(g for _n, g in groups)):
        n = tensors[0].numel()
        if n == 0:
            continue
        rows.append(tuple(t.data_ptr() for t in tensors) + (n, chunk0))
        chunk0 += -(-n // CHUNK)
    if not rows:
        return None
    if chunk0 > 2 ** 31 - 1:
        raise ValueError("%s: %d chunks exceed the grid" % (what, chunk0))
    # the table rides a pinned buffer and an asynchronous copy on the
    # launching stream, so the step does not wait for the device
    table = torch.tensor(rows, dtype=torch.int64).pin_memory() \
        .to(dev, non_blocking=True)
    return table, len(rows), chunk0


def multi_trainer_adam(ws, gs, ms, vs, lr, wd, b1, b2, eps, t, adamw=False):
    """One Adam / AdamW step of step number ``t`` over the tensors ``ws``
    with gradients ``gs`` and moments ``ms``, ``vs``, all updated in place
    (fp32, one launch on CUDA). Returns ``(ws, ms, vs)``."""
    ws, gs, ms, vs = list(ws), list(gs), list(ms), list(vs)
    if not (len(ws) == len(gs) == len(ms) == len(vs)):
        raise ValueError("multi_trainer_adam: %d weights, %d grads, %d m, "
                         "%d v" % (len(ws), len(gs), len(ms), len(vs)))
    if not ws:
        return ws, ms, vs
    if all(x.device.type == "cpu" for x in ws + gs + ms + vs):
        return multi_trainer_adam_reference(ws, gs, ms, vs, lr, wd, b1, b2,
                                            eps, t, adamw)
    launch = _table("multi_trainer_adam",
                    (("w", ws), ("g", gs), ("m", ms), ("v", vs)))
    if launch is None:
        return ws, ms, vs
    table, n_tensors, n_chunks = launch
    dev = ws[0].device
    sc = adam_scalars(lr, wd, b1, b2, eps, t)
    lib = _build.library()
    rc = lib.mxtpu_trainer_adam_f32(
        table.data_ptr(), n_tensors, n_chunks, *(float(sc[k]) for k in (
            "lr", "wd", "b1", "b2", "one_minus_b1", "one_minus_b2", "bias1",
            "bias2", "eps", "lrwd")),
        int(bool(adamw)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "multi_trainer_adam")
    _build.count_launch(multi_trainer_adam)
    return ws, ms, vs


multi_trainer_adam.launches = 0


def sgd_mom_scalars(lr, wd, momentum):
    """lr, wd and momentum as the f32 values the kernel computes with."""
    f = np.float32
    return dict(lr=f(lr), wd=f(wd), momentum=f(momentum))


def multi_trainer_sgd_mom_reference(ws, gs, moms, lr, wd, momentum):
    """Plain per-tensor SGD with momentum in the trainer formulation, in
    place on ``ws`` and ``moms``, with the kernel's f32 scalars (as 0-dim
    tensors on the tensors' device) and order of operations."""
    sc = sgd_mom_scalars(lr, wd, momentum)
    consts = {}
    with torch.no_grad():
        for w, g, m in zip(ws, gs, moms):
            if w.device not in consts:
                consts[w.device] = {k: torch.tensor(val, dtype=torch.float32,
                                                    device=w.device)
                                    for k, val in sc.items()}
            c = consts[w.device]
            m.mul_(c["momentum"]).sub_(c["lr"] * (g + c["wd"] * w))
            w.add_(m)
    return ws, moms


def multi_trainer_sgd_mom(ws, gs, moms, lr, wd, momentum):
    """One SGD-with-momentum step over the tensors ``ws`` with gradients
    ``gs`` and momenta ``moms``, both updated in place (fp32, one launch on
    CUDA). Returns ``(ws, moms)``."""
    ws, gs, moms = list(ws), list(gs), list(moms)
    if not (len(ws) == len(gs) == len(moms)):
        raise ValueError("multi_trainer_sgd_mom: %d weights, %d grads, %d "
                         "momenta" % (len(ws), len(gs), len(moms)))
    if not ws:
        return ws, moms
    if all(x.device.type == "cpu" for x in ws + gs + moms):
        return multi_trainer_sgd_mom_reference(ws, gs, moms, lr, wd,
                                               momentum)
    launch = _table("multi_trainer_sgd_mom",
                    (("w", ws), ("g", gs), ("mom", moms)))
    if launch is None:
        return ws, moms
    table, n_tensors, n_chunks = launch
    dev = ws[0].device
    sc = sgd_mom_scalars(lr, wd, momentum)
    rc = _build.library().mxtpu_trainer_sgd_mom_f32(
        table.data_ptr(), n_tensors, n_chunks, float(sc["lr"]),
        float(sc["wd"]), float(sc["momentum"]), 1.0, -1.0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "multi_trainer_sgd_mom")
    _build.count_launch(multi_trainer_sgd_mom)
    return ws, moms


multi_trainer_sgd_mom.launches = 0


# ---------------------------------------------------------------------------
# the eager gluon Trainer's flavours (the _optim_kernels seam)
# ---------------------------------------------------------------------------

#: the flat kernels' storage types, in the order of a call's ``entries``
_FLAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _group(what, groups):
    """The lists of one call as lists, of equal lengths and one dtype."""
    groups = [(name, list(ts)) for name, ts in groups]
    lens = {len(ts) for _n, ts in groups}
    if len(lens) != 1:
        raise ValueError("%s: %s" % (what, ", ".join(
            "%d %s" % (len(ts), name) for name, ts in groups)))
    dtypes = {t.dtype for _n, ts in groups for t in ts}
    if len(dtypes) > 1:
        raise ValueError("%s: one call takes one dtype, these lists mix %s"
                         % (what, ", ".join(sorted(map(str, dtypes)))))
    return groups


def _on_cpu(groups):
    return all(t.device.type == "cpu" for _n, ts in groups for t in ts)


def _rounder(dtype):
    """x -> x rounded to f32, then to ``dtype`` (ties to even), as a
    float."""
    return lambda x: float(torch.tensor(float(np.float32(x)), dtype=dtype))


def _launch(what, groups, entries, scalars, clip):
    """One launch of the lists' dtype's flavour over the table of
    ``groups``, counted on that flavour's wrapper. ``entries`` holds a
    (wrapper, C entry) pair for each of ``_FLAT_DTYPES``, in its order;
    ``scalars`` are rounded to f32 and then to the lists' dtype, and
    ``clip`` after them is -1 when off."""
    dtype = groups[0][1][0].dtype
    if dtype not in _FLAT_DTYPES:
        raise TypeError("%s: the CUDA kernel takes float32, bfloat16 or "
                        "float16, got %s" % (what, dtype))
    launch = _table(what, groups, dtype)
    if launch is None:
        return
    table, n_tensors, n_chunks = launch
    wrapper, entry = entries[_FLAT_DTYPES.index(dtype)]
    rnd = _rounder(dtype)
    clip = rnd(clip) if float(np.float32(clip)) > 0 else -1.0
    dev = groups[0][1][0].device
    rc = getattr(_build.library(), entry)(
        table.data_ptr(), n_tensors, n_chunks, *map(rnd, scalars), clip,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    _build.count_launch(wrapper)


def fused_sgd_mom_flat_reference(ws, gs, moms, lr, wd, momentum, rescale,
                                 clip):
    """``_sgd_mom_update`` tensor by tensor, in place."""
    for w, g, m in zip(ws, gs, moms):
        _rules._sgd_mom_update(w, g, m, lr, wd, momentum, rescale, clip)
    return ws, moms


def fused_sgd_mom_flat(ws, gs, moms, lr, wd, momentum, rescale, clip):
    """One SGD-momentum step with the rescale / clip prologue over the
    tensors ``ws``, gradients ``gs`` and momenta ``moms``, in place (fp32,
    bf16 or fp16, one launch on CUDA). Returns ``(ws, moms)``."""
    groups = _group("fused_sgd_mom_flat",
                    (("w", ws), ("g", gs), ("mom", moms)))
    ws, gs, moms = (ts for _n, ts in groups)
    if not ws:
        return ws, moms
    if _on_cpu(groups):
        return fused_sgd_mom_flat_reference(ws, gs, moms, lr, wd, momentum,
                                            rescale, clip)
    _launch("fused_sgd_mom_flat", groups,
            ((fused_sgd_mom_flat, "mxtpu_trainer_sgd_mom_f32"),
             (fused_sgd_mom_flat_bf16, "mxtpu_flat_sgd_mom_bf16"),
             (fused_sgd_mom_flat_f16, "mxtpu_flat_sgd_mom_f16")),
            (lr, wd, momentum, rescale), clip)
    return ws, moms


fused_sgd_mom_flat.launches = 0


def fused_adam_flat_reference(ws, gs, ms, vs, lr, wd, b1, b2, eps, t,
                              rescale, clip):
    """``_adam_update`` tensor by tensor, in place."""
    coef = _rules.adam_coef(lr, b1, b2, t)
    for w, g, m, v in zip(ws, gs, ms, vs):
        _rules._adam_update(w, g, m, v, lr, wd, b1, b2, eps, t, rescale,
                            clip, coef=coef)
    return ws, ms, vs


def fused_adam_flat(ws, gs, ms, vs, lr, wd, b1, b2, eps, t, rescale, clip):
    """One Adam step of step number ``t`` with the rescale / clip prologue,
    in place (fp32, bf16 or fp16, one launch on CUDA). Returns
    ``(ws, ms, vs)``."""
    groups = _group("fused_adam_flat",
                    (("w", ws), ("g", gs), ("m", ms), ("v", vs)))
    ws, gs, ms, vs = (ts for _n, ts in groups)
    if not ws:
        return ws, ms, vs
    if _on_cpu(groups):
        return fused_adam_flat_reference(ws, gs, ms, vs, lr, wd, b1, b2, eps,
                                         t, rescale, clip)
    f = np.float32
    _launch("fused_adam_flat", groups,
            ((fused_adam_flat, "mxtpu_flat_adam_f32"),
             (fused_adam_flat_bf16, "mxtpu_flat_adam_bf16"),
             (fused_adam_flat_f16, "mxtpu_flat_adam_f16")),
            (_rules.adam_coef(lr, b1, b2, t), wd, b1, b2, 1 - f(b1),
             1 - f(b2), eps, rescale), clip)
    return ws, ms, vs


fused_adam_flat.launches = 0


def fused_adamw_flat_reference(ws, gs, ms, vs, lr, wd, eta, b1, b2, eps, t,
                               rescale, clip):
    """``_adamw_update`` tensor by tensor, in place."""
    bias = _rules.adamw_bias(b1, b2, t)
    for w, g, m, v in zip(ws, gs, ms, vs):
        _rules._adamw_update(w, g, m, v, lr, wd, eta, b1, b2, eps, t,
                             rescale, clip, bias=bias)
    return ws, ms, vs


def fused_adamw_flat(ws, gs, ms, vs, lr, wd, eta, b1, b2, eps, t, rescale,
                     clip):
    """One AdamW step of step number ``t`` with the rescale / clip
    prologue, in place (fp32, bf16 or fp16, one launch on CUDA). Returns
    ``(ws, ms, vs)``."""
    groups = _group("fused_adamw_flat",
                    (("w", ws), ("g", gs), ("m", ms), ("v", vs)))
    ws, gs, ms, vs = (ts for _n, ts in groups)
    if not ws:
        return ws, ms, vs
    if _on_cpu(groups):
        return fused_adamw_flat_reference(ws, gs, ms, vs, lr, wd, eta, b1,
                                          b2, eps, t, rescale, clip)
    f = np.float32
    bias1, bias2 = _rules.adamw_bias(b1, b2, t)
    _launch("fused_adamw_flat", groups,
            ((fused_adamw_flat, "mxtpu_flat_adamw_f32"),
             (fused_adamw_flat_bf16, "mxtpu_flat_adamw_bf16"),
             (fused_adamw_flat_f16, "mxtpu_flat_adamw_f16")),
            (lr, wd, eta, b1, b2, 1 - f(b1), 1 - f(b2), bias1, bias2, eps,
             rescale), clip)
    return ws, ms, vs


fused_adamw_flat.launches = 0


def _flavour(flat, dtype, suffix):
    """``flat`` restricted to ``dtype`` lists: the wrapper named
    ``<flat>_<suffix>`` on whose ``launches`` ``flat`` counts the launches
    of that dtype's kernel."""
    what = "%s_%s" % (flat.__name__, suffix)

    def wrapper(ws, *args, **kwargs):
        ws = list(ws)
        if ws and ws[0].dtype != dtype:
            raise TypeError("%s: takes %s lists, w[0] is %s"
                            % (what, str(dtype)[6:], ws[0].dtype))
        return flat(ws, *args, **kwargs)

    wrapper.__name__ = wrapper.__qualname__ = what
    wrapper.__doc__ = ("``%s`` on %s lists: the %s kernel's entry, whose "
                       "launches are counted here." % (
                           flat.__name__, str(dtype)[6:], suffix))
    wrapper.launches = 0
    return wrapper


fused_sgd_mom_flat_bf16 = _flavour(fused_sgd_mom_flat, torch.bfloat16,
                                   "bf16")
fused_adam_flat_bf16 = _flavour(fused_adam_flat, torch.bfloat16, "bf16")
fused_adamw_flat_bf16 = _flavour(fused_adamw_flat, torch.bfloat16, "bf16")
fused_sgd_mom_flat_f16 = _flavour(fused_sgd_mom_flat, torch.float16, "f16")
fused_adam_flat_f16 = _flavour(fused_adam_flat, torch.float16, "f16")
fused_adamw_flat_f16 = _flavour(fused_adamw_flat, torch.float16, "f16")
