"""ShardedTrainer's fused Adam / AdamW update: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``multi_trainer_adam`` and ``_trainer_adam_kernel`` in
``incubator_mxnet_tpu/ops/pallas/fused_optim.py`` (the trainer formulation:
no rescale or clip; Adam through mhat / vhat; AdamW adds ``lr*wd * w``). The
kernel is in ``csrc/fused_optim.cu``. The JAX function returns new arrays;
this one updates the fp32 ``ws``, ``ms`` and ``vs`` in place, so the state is
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

For CPU tensors ``multi_trainer_adam`` takes the plain version; for CUDA
tensors it launches the kernel once for all of them or raises, and adds one
to its ``launches`` count.
"""

import numpy as np
import torch

from . import _build

__all__ = ["multi_trainer_adam", "multi_trainer_adam_reference",
           "adam_scalars"]

CHUNK = 32768          # elements a block updates (csrc/fused_optim.cu kChunk)


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


def _check_cuda(ws, gs, ms, vs):
    dev = ws[0].device
    for name, group in (("w", ws), ("g", gs), ("m", ms), ("v", vs)):
        for i, t in enumerate(group):
            if t.device != dev:
                raise ValueError("multi_trainer_adam: %s[%d] on %s, w[0] on "
                                 "%s" % (name, i, t.device, dev))
            if t.dtype != torch.float32:
                raise TypeError("multi_trainer_adam: the CUDA kernel takes "
                                "float32, %s[%d] is %s" % (name, i, t.dtype))
            if not t.is_contiguous():
                raise ValueError("multi_trainer_adam: %s[%d] is not "
                                 "contiguous" % (name, i))
            if t.shape != ws[i].shape:
                raise ValueError("multi_trainer_adam: %s[%d] has shape %s, "
                                 "w[%d] %s" % (name, i, tuple(t.shape), i,
                                               tuple(ws[i].shape)))


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
    dev = ws[0].device
    if all(x.device.type == "cpu" for x in ws + gs + ms + vs):
        return multi_trainer_adam_reference(ws, gs, ms, vs, lr, wd, b1, b2,
                                            eps, t, adamw)
    if dev.type != "cuda":
        raise ValueError("multi_trainer_adam: unsupported device %s" % dev)
    _check_cuda(ws, gs, ms, vs)
    rows, chunk0 = [], 0
    for w, g, m, v in zip(ws, gs, ms, vs):
        n = w.numel()
        if n == 0:
            continue
        rows.append((w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, chunk0))
        chunk0 += -(-n // CHUNK)
    if not rows:
        return ws, ms, vs
    if chunk0 > 2 ** 31 - 1:
        raise ValueError("multi_trainer_adam: %d chunks exceed the grid"
                         % chunk0)
    # the table rides a pinned buffer and an asynchronous copy on the
    # launching stream, so the step does not wait for the device
    table = torch.tensor(rows, dtype=torch.int64).pin_memory() \
        .to(dev, non_blocking=True)
    sc = adam_scalars(lr, wd, b1, b2, eps, t)
    lib = _build.library()
    rc = lib.mxtpu_trainer_adam_f32(
        table.data_ptr(), len(rows), chunk0, *(float(sc[k]) for k in (
            "lr", "wd", "b1", "b2", "one_minus_b1", "one_minus_b2", "bias1",
            "bias2", "eps", "lrwd")),
        int(bool(adamw)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "multi_trainer_adam")
    _build.count_launch(multi_trainer_adam)
    return ws, ms, vs


multi_trainer_adam.launches = 0
