"""Per-program FLOPs/bytes accounting and MFU on the card.

Counterpart of ``incubator_mxnet_tpu/telemetry/costs.py``. The JAX package
reads a compiled executable's static cost from XLA's cost analysis. The
port has no compiled executable to ask, so ``count(fn, *inputs)`` runs the
program once and counts what it does:

- the aten products through ``torch.utils.flop_counter.FlopCounterMode``
  (matmuls, convolutions, SDPA: the products, as XLA counts them);
- the bytes every aten op reads and writes (operands and results, views
  excluded);
- the hand-written kernels, which no dispatch mode sees (they launch
  through ctypes), by formula: each wrapper hands ``_build.count_launch``
  the FLOPs and bytes of its launch (the formulas below, the same as the
  kernel bounds of ``chip_smoke.py``), and ``_build.counting_costs`` adds
  them up. The normalisation kernels (LayerNorm, softmax) count bytes and
  no FLOPs, as FlopCounterMode counts their plain versions.

``compilecache/aot.py``'s ``BlockProgram`` counts each served shape once, at
its eager first call, under ``MXTPU_COSTS=1``; a CUDA graph replay cannot be
counted (nothing dispatches). The eager path (the CPU, or ``graphs`` off)
counts the same way at a shape's first call. ``capture()`` records the
count under the program's name, and ``observe()`` turns each timed
execution into achieved TFLOP/s, tokens/s and ``model_flops_utilization``
(achieved FLOP/s over the peak) gauges. Counting never fails a batch, but a
failed count is not silent: ``capture_failed()`` leaves a
``costs.capture_failed`` flight event and a
``mxtpu_costs_capture_errors_total`` count.

Peak defaults are the NVIDIA H100 SXM's, for the precision the port
computes in (fp32, TF32 off): 67 TFLOP/s on the CUDA cores and 3.35 TB/s of
device memory. ``MXTPU_PEAK_TFLOPS`` / ``MXTPU_PEAK_GBS`` override them.
"""

import os
import threading

from . import metrics as _m
from . import catalog as _cat

__all__ = ["capture_enabled", "count", "run_counted", "capture",
           "capture_failed",
           "captured", "observe", "mfu", "peak_flops", "peak_bytes",
           "reset", "flash_forward_cost", "flash_decode_cost",
           "int8_matmul_cost", "rows_cost", "H100_FP32_TFLOPS",
           "H100_HALF_TFLOPS", "H100_HBM_GBS"]

#: NVIDIA H100 SXM, dense fp32 on the CUDA cores (data sheet)
H100_FP32_TFLOPS = 67.0
#: NVIDIA H100 SXM, dense bf16 and fp16 on the tensor cores (data sheet):
#: the rate that bounds the 16-bit kernels' operations (their bytes count
#: 2-byte elements in the formulas below)
H100_HALF_TFLOPS = 989.0
#: NVIDIA H100 SXM HBM3 bandwidth (data sheet)
H100_HBM_GBS = 3350.0

_lock = threading.Lock()
_captured = {}


def capture_enabled():
    """True when cost counting (one counted eager run per program) is
    opted in with MXTPU_COSTS=1."""
    return os.environ.get("MXTPU_COSTS", "0") == "1"


def peak_flops():
    """Peak in FLOP/s (MXTPU_PEAK_TFLOPS, default the H100 SXM's fp32)."""
    try:
        return float(os.environ.get("MXTPU_PEAK_TFLOPS",
                                    str(H100_FP32_TFLOPS))) * 1e12
    except ValueError:
        return H100_FP32_TFLOPS * 1e12


def peak_bytes():
    """Device memory rate in bytes/s (MXTPU_PEAK_GBS, default the H100
    SXM's)."""
    try:
        return float(os.environ.get("MXTPU_PEAK_GBS",
                                    str(H100_HBM_GBS))) * 1e9
    except ValueError:
        return H100_HBM_GBS * 1e9


# -- the hand kernels' work, by formula ------------------------------------
def rows_cost(rows, C, params=0, elem_bytes=4):
    """(flops, bytes) of a row-wise normalisation (LayerNorm, softmax):
    each row read and written once, ``params`` per-column vectors read
    (``elem_bytes`` an element: 2 for the bf16 and fp16 kernels); no
    products."""
    return 0.0, float((2 * rows * C + params * C) * elem_bytes)


def flash_forward_cost(H, T, D, lengths, elem_bytes=4):
    """(bytes, live_flops, dense_flops) of the flash forward over B = len(
    lengths) samples whose keys past lengths[b] are masked: q, k, v read
    and out written once (``elem_bytes`` an element: 2 for bf16 and
    fp16), lse written, and the
    fp32 bias read where any key is masked; QK^T and PV over the live keys,
    and over every key."""
    B = len(lengths)
    dense = min(lengths) == T
    flash_bytes = (4 * B * H * T * D * elem_bytes
                   + (B * H * T + (0 if dense else B * H * T)) * 4)
    return (flash_bytes, 4 * H * T * D * sum(lengths),
            4 * B * H * T * T * D)


def flash_decode_cost(S, C, H, D, live, mb, q_bytes=4, kv_bytes=4):
    """(bytes, flops) of one paged flash-decode call: the K and V rows of
    the ``live`` past positions read once (``kv_bytes`` an element: 2 for
    a bf16 or fp16 pool), q read and out written (``q_bytes`` an element:
    2 for a bf16 or fp16 q), m and l
    written in fp32, the int32 block tables and lengths read; QK^T and PV
    of each of the C chunk positions against the live past."""
    fd_bytes = (2 * live * H * D * kv_bytes + 2 * S * C * H * D * q_bytes
                + (2 * S * C * H + S * mb + S) * 4)
    return fd_bytes, 4 * C * H * D * live


def int8_matmul_cost(M, N, K):
    """(bytes, ops) of an int8 (M, K) x (N, K)^T product with int32
    output."""
    return M * K + N * K + 4 * M * N, 2 * M * N * K


# -- counting ----------------------------------------------------------------
def _bytes_mode():
    """A dispatch mode adding up the bytes of every aten op's tensor
    operands and results (views move nothing and are skipped)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                for t in tree_flatten((args, kwargs, out))[0]:
                    if isinstance(t, torch.Tensor):
                        self.total += t.numel() * t.element_size()
            return out

    return _Bytes()


def count(fn, *inputs):
    """Run ``fn(*inputs)`` once and count its work. Returns ``(result,
    cost)`` with cost ``{"flops", "bytes", "aten_flops", "kernel_flops",
    "kernels": {wrapper name: [launches, flops, bytes]}}``."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..ops.kernels import _build
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = _bytes_mode()
    with _build.counting_costs() as kern:
        with flop_mode:
            with bytes_mode:
                result = fn(*inputs)
    aten = float(flop_mode.get_total_flops())
    cost = {"flops": aten + kern["flops"],
            "bytes": float(bytes_mode.total) + kern["bytes"],
            "aten_flops": aten, "kernel_flops": kern["flops"],
            "kernels": {k: list(v) for k, v in kern["kernels"].items()}}
    return result, cost


def run_counted(name, fn, inputs, samples_per_exec=None):
    """``fn(*inputs)``, counted and captured under ``name`` when
    ``MXTPU_COSTS=1``. Counting never fails the call: a failed count runs
    it again uncounted and is counted as a failure (``capture_failed``).
    Returns ``(result, cost or None)``."""
    if not capture_enabled():
        return fn(*inputs), None
    try:
        result, cost = count(fn, *inputs)
    except Exception as e:  # noqa: BLE001 - see above
        capture_failed(name, e)
        return fn(*inputs), None
    capture(name, cost, samples_per_exec=samples_per_exec)
    return result, cost


def capture(name, cost, samples_per_exec=None):
    """Record the cost of one run of the program ``name`` (a ``count()``
    result, or any {"flops", "bytes"} dict). Returns the stored entry."""
    entry = {"flops": float(cost.get("flops", 0.0)),
             "bytes": float(cost.get("bytes", 0.0)),
             "samples": samples_per_exec}
    with _lock:
        _captured[name] = entry
    if _m._state["enabled"]:
        _cat.model_flops_per_exec.set(entry["flops"], name=name)
        _cat.model_bytes_per_exec.set(entry["bytes"], name=name)
    return entry


def capture_failed(name, error):
    """A program whose count failed: the batch goes on, the failure is
    counted and left on the flight ring."""
    from . import flight as _fl
    _fl.record("costs.capture_failed", name=name,
               error="%s: %s" % (type(error).__name__, str(error)[:200]))
    _cat.costs_capture_errors.inc(name=name)


def captured(name=None):
    with _lock:
        if name is not None:
            ent = _captured.get(name)
            return dict(ent) if ent else None
        return {k: dict(v) for k, v in _captured.items()}


def reset():
    with _lock:
        _captured.clear()


def observe(name, seconds, execs=1):
    """Fold one timed execution window into the achieved/MFU gauges.
    One predicate check when telemetry is off; a dict miss when ``name``
    was never captured."""
    if not _m._state["enabled"]:
        return
    with _lock:
        ent = _captured.get(name)
    if ent is None or seconds <= 0:
        return
    achieved = ent["flops"] * execs / seconds
    _cat.model_achieved_tflops.set(achieved / 1e12, name=name)
    _cat.model_flops_utilization.set(achieved / peak_flops(), name=name)
    if ent["samples"]:
        _cat.model_tokens_per_sec.set(ent["samples"] * execs / seconds,
                                      name=name)


def mfu(flops, seconds, execs=1):
    """Model FLOPs utilization: fraction of the peak achieved by running
    ``execs`` executions of ``flops`` FLOPs in ``seconds``."""
    if seconds <= 0:
        return 0.0
    return flops * execs / seconds / peak_flops()
