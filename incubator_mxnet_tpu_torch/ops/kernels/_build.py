"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, ``build/torch_kernels/libmxtpu_torch_kernels.so`` under the
checkout. A stamp file beside it holds the hash of the sources, the headers
they share (``csrc/*.cuh``) and the flags; a changed source or header
rebuilds it. A failed build raises ``KernelBuildError``
carrying the compiler's output: there is no fallback.

Nothing here runs at import time. The CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["KernelBuildError", "KernelLaunchError", "library", "build_info",
           "check", "count_launch", "recording_launches", "add_launches",
           "counting_costs",
           "sources", "BUILD_DIR", "LIB_NAME"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libmxtpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of each C entry point (all return an int error code)
_SIGNATURES = {
    # x, gamma, beta, y, rows, C, eps, route, device, stream
    "mxtpu_layer_norm_f32": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    # x, y, rows, C, device, stream
    "mxtpu_softmax_f32": (_P, _P, _I, _I, _I, _P),
    # the bf16 and fp16 flavours of the two, with the same arguments but
    # softmax's route before device: x, y, rows, C, route, device, stream
    "mxtpu_layer_norm_bf16": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    "mxtpu_softmax_bf16": (_P, _P, _I, _I, _I, _I, _P),
    "mxtpu_layer_norm_f16": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    "mxtpu_softmax_f16": (_P, _P, _I, _I, _I, _I, _P),
    # q, k, v, bias, out, lse, bh, T, D, scale, causal, device, stream
    "mxtpu_flash_attention_fwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _F, _I, _I, _P),
    # q, k, v, dout, lse, delta, bias, dq, bh, T, D, scale, causal, device,
    # stream
    "mxtpu_flash_attention_bwd_dq_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _F, _I, _I, _P),
    # q, k, v, dout, lse, delta, bias, dk, dv, dbias, bh, T, D, scale,
    # causal, device, stream
    "mxtpu_flash_attention_bwd_dkv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _I, _I, _I, _F, _I, _I, _P),
    # the bf16 and fp16 flavours, with the fp32 entries' arguments (dbias
    # null for none)
    "mxtpu_flash_attention_fwd_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _F, _I, _I, _P),
    # the 16-bit dQ entries read out and write delta: q, k, v, dout, out,
    # lse, bias, dq, delta, bh, T, D, scale, causal, device, stream
    "mxtpu_flash_attention_bwd_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _F, _I, _I, _P),
    "mxtpu_flash_attention_bwd_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _I, _I, _I, _F, _I, _I,
                                           _P),
    "mxtpu_flash_attention_fwd_f16": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _F, _I, _I, _P),
    "mxtpu_flash_attention_bwd_dq_f16": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _F, _I, _I, _P),
    "mxtpu_flash_attention_bwd_dkv_f16": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _I, _I, _I, _F, _I, _I, _P),
    # q, k, p, s, o, D, dtype (0 bf16, 1 fp16), device, stream: one wgmma
    # tile through the 16-bit backward's descriptors (a card test's probe)
    "mxtpu_flash_bwd_wgmma_probe": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # table, n_tensors, n_chunks, lr, wd, b1, b2, 1 - b1, 1 - b2, 1 - b1^t,
    # 1 - b2^t, eps, lr * wd, adamw, device, stream
    "mxtpu_trainer_adam_f32": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                               _F, _F, _I, _I, _P),
    # table, n_tensors, n_chunks, lr, wd, momentum, rescale, clip, device,
    # stream
    "mxtpu_trainer_sgd_mom_f32": (_P, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    # table, n_tensors, n_chunks, coef, wd, b1, b2, 1 - b1, 1 - b2, eps,
    # rescale, clip, device, stream
    "mxtpu_flat_adam_f32": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                            _I, _P),
    # table, n_tensors, n_chunks, lr, wd, eta, b1, b2, 1 - b1, 1 - b2,
    # 1 - b1^t, 1 - b2^t, eps, rescale, clip, device, stream
    "mxtpu_flat_adamw_f32": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                             _F, _F, _F, _I, _P),
    # the bf16 and fp16 flavours of the three eager entries, with the same
    # arguments
    "mxtpu_flat_sgd_mom_bf16": (_P, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    "mxtpu_flat_adam_bf16": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                             _I, _P),
    "mxtpu_flat_adamw_bf16": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                              _F, _F, _F, _I, _P),
    "mxtpu_flat_sgd_mom_f16": (_P, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    "mxtpu_flat_adam_f16": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                            _I, _P),
    "mxtpu_flat_adamw_f16": (_P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                             _F, _F, _F, _I, _P),
    # x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B, H, W, C, M, route,
    # device, stream
    "mxtpu_fused_bottleneck": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P),
    # a, w, c, M, N, K, route, device, stream
    "mxtpu_int8_matmul_nk": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # device, stream: an empty kernel (a launch's floor)
    "mxtpu_noop": (_I, _P),
    # q, k_pool, v_pool, tables, lengths, out, m, l, S, C, H, D, num_blocks,
    # block_size, max_blocks, scale, device, stream
    "mxtpu_flash_decode_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _P),
    # bf16 q and out over pools of kv_dtype (0 bf16, 1 fp32): the fp32
    # entry's arguments with kv_dtype before device
    "mxtpu_flash_decode_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _F, _I, _I, _P),
    # fp16 q and out over pools of kv_dtype (0 fp16, 1 fp32), likewise
    "mxtpu_flash_decode_f16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _F, _I, _I, _P),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_state = {"lib": None, "built": False, "seconds": 0.0}
_capture = threading.local()      # .launches: {wrapper: n} while capturing;
#                                   .costs: the counted work (counting_costs)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its output."""


class KernelLaunchError(RuntimeError):
    """A C entry point returned a CUDA error (a refused or failed launch)."""


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The headers the sources share; they are compiled through the
    sources, and hashed into the stamp beside them."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def _stamp(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _compile(nvcc, srcs, lib_path):
    """One nvcc per source, all in flight at once, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            obj = os.path.join(tmp, s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append("$ %s\n%s" % (" ".join(cmd), out))
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *[o for _c, o, _p in procs],
               "-o", tmp_lib]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise KernelBuildError("nvcc link failed:\n$ %s\n%s"
                                   % (" ".join(cmd), r.stdout))
        os.replace(tmp_lib, lib_path)


def library():
    """The loaded kernel library, built first if it is missing or stale."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        srcs = sources()
        if not srcs:
            raise KernelBuildError("no CUDA sources under %s" % CSRC)
        stamp = _stamp(srcs + headers())
        lib_path = BUILD_DIR / LIB_NAME
        stamp_path = BUILD_DIR / (LIB_NAME + ".sha256")
        fresh = (lib_path.exists() and stamp_path.exists()
                 and stamp_path.read_text().strip() == stamp)
        if not fresh:
            t0 = time.perf_counter()
            _compile(_nvcc(), srcs, lib_path)
            tmp_stamp = stamp_path.with_suffix(".tmp%d" % os.getpid())
            tmp_stamp.write_text(stamp + "\n")
            os.replace(tmp_stamp, stamp_path)
            _state["built"] = True
            _state["seconds"] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        _state["lib"] = lib
        return lib


def build_info():
    """{"path", "built" (this process compiled it), "seconds"}."""
    return {"path": str(BUILD_DIR / LIB_NAME), "built": _state["built"],
            "seconds": _state["seconds"]}


def check(rc, what):
    """Raise KernelLaunchError when a C entry point returned an error."""
    if rc != 0:
        msg = _state["lib"].mxtpu_cuda_error_string(rc).decode()
        raise KernelLaunchError("%s: CUDA error %d (%s)" % (what, rc, msg))


def count_launch(wrapper, cost=None):
    """Add one to ``wrapper.launches``; batchers of several models launch
    from their own threads. While this thread captures a CUDA graph
    (``recording_launches``) the kernel is recorded, not run: the call is
    counted in the capture's record instead, and each replay of the graph
    adds the record (``add_launches``). ``cost`` is a zero-argument callable
    giving the launch's (flops, bytes); it is called only while this
    thread counts costs (``counting_costs``)."""
    acc = getattr(_capture, "costs", None)
    if acc is not None and cost is not None:
        flops, nbytes = cost()
        acc["flops"] += flops
        acc["bytes"] += nbytes
        ent = acc["kernels"].setdefault(wrapper.__name__, [0, 0.0, 0.0])
        ent[0] += 1
        ent[1] += flops
        ent[2] += nbytes
    record = getattr(_capture, "launches", None)
    if record is not None:
        record[wrapper] = record.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


class counting_costs:
    """Context manager: the kernel launches made on this thread inside it
    add their (flops, bytes) to the dict it returns, ``{"flops", "bytes",
    "kernels": {wrapper name: [launches, flops, bytes]}}``
    (``telemetry.costs.count``)."""

    def __enter__(self):
        if getattr(_capture, "costs", None) is not None:
            raise RuntimeError("costs are already being counted on this "
                               "thread")
        _capture.costs = {"flops": 0.0, "bytes": 0.0, "kernels": {}}
        return _capture.costs

    def __exit__(self, *_exc):
        _capture.costs = None


class recording_launches:
    """Context manager: the wrapper calls made on this thread inside it go
    to the dict it returns (``{wrapper: calls}``), not to the counts."""

    def __enter__(self):
        if getattr(_capture, "launches", None) is not None:
            raise RuntimeError("launches are already being recorded on this "
                               "thread")
        _capture.launches = {}
        return _capture.launches

    def __exit__(self, *_exc):
        _capture.launches = None


def add_launches(record):
    """Add a capture's record (``{wrapper: calls}``) to the counts: one
    replay of the graph launched each of those kernels that many times."""
    with _count_lock:
        for wrapper, n in record.items():
            wrapper.launches += n
