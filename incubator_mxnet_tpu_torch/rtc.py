"""mx.rtc - kernels compiled from CUDA source at run time.

Counterpart of ``incubator_mxnet_tpu/rtc.py``. The JAX package compiles
user *Pallas* source (``PallasModule``, whose ``PallasKernel.launch`` reaches
``pl.pallas_call``) and its ``CudaModule`` raises. On the H100 the kernel
language is CUDA C++, so this module is the reference MXNet API that the JAX
file names (python/mxnet/rtc.py over src/common/rtc.cc):

    mod = rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    k.launch([x, y, 3.0], mx.gpu(0), grid_dims, block_dims, shared_mem=0)

``CudaModule`` compiles the source with NVRTC for ``sm_90a`` into a cubin
(``nvrtcGetCUBIN``), and caches it under ``build/rtc/`` of the checkout by a
hash of the source, the options, the exports, the architecture and NVRTC's
version; a second module of the same source loads the cubin and compiles
nothing. ``exports`` names kernels that are not ``extern "C"`` (a template
instantiation such as ``"scale<float>"``); their mangled names come from
``nvrtcAddNameExpression`` / ``nvrtcGetLoweredName`` and are cached beside
the cubin. Kernels load and launch through the CUDA driver API
(``cuModuleLoadData``, ``cuModuleGetFunction``, ``cuLaunchKernel``) in the
device's primary context, the one PyTorch uses, on PyTorch's current stream.
Both libraries are reached with ctypes: ``libnvrtc`` from the toolkit
(``$CUDA_HOME/lib64``, ``/usr/local/cuda/lib64``, then the loader's path)
and ``libcuda``. A missing library raises ``RtcError``: there is no other
compiler to fall back to.

Arguments follow the signature string (``parse_signature``): a pointer
type takes an NDArray or a tensor of that dtype, contiguous, on the launch's
device; a value type takes a number, packed as its C type. The context must
be a GPU; CPU arrays raise. Each ``CudaKernel`` counts its launches in
``launches``.

``PallasModule`` and ``PallasKernel`` raise NotImplementedError naming
``CudaModule``, as the JAX package's ``CudaModule`` names ``PallasModule``.
"""

import collections
import ctypes
import ctypes.util
import glob
import hashlib
import json
import os
import re
import threading
import time

import numpy as np
import torch

from .context import resolve_device
from .ops.kernels import _build

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "RtcError", "parse_signature", "Arg", "ARCH", "CACHE_DIR"]

ARCH = "sm_90a"
CACHE_DIR = _build.BUILD_DIR.parent / "rtc"

# C type -> (torch dtype of an array argument, numpy dtype of a value)
_CTYPES = {
    "float": (torch.float32, np.float32),
    "double": (torch.float64, np.float64),
    "__half": (torch.float16, np.float16),
    "__nv_bfloat16": (torch.bfloat16, None),
    "uint8_t": (torch.uint8, np.uint8),
    "int": (torch.int32, np.int32),
    "int32_t": (torch.int32, np.int32),
    "int8_t": (torch.int8, np.int8),
    "char": (torch.int8, np.int8),
    "int64_t": (torch.int64, np.int64),
}

_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


class RtcError(RuntimeError):
    """NVRTC or the CUDA driver is missing or refused a source or launch;
    the message holds the compiler's log or the CUDA error."""


#: one parameter of a kernel signature: its C type, the torch dtype of an
#: array passed for it, whether it is a pointer, const, and its name (or None)
Arg = collections.namedtuple("Arg", "ctype dtype pointer const name")


def parse_signature(signature):
    """``"const float *x, float *y, int n"`` -> [Arg, ...]: each parameter
    in the reference's form ``(const) type (*) (name)``. Raises ValueError
    for a malformed parameter and TypeError for a type it cannot pass."""
    args = []
    for part in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(part)
        if not m or m.group(2) == "const":
            raise ValueError('invalid kernel parameter "%s": it must be of '
                             'the form "(const) type (*) (name)"'
                             % part.strip())
        const, ctype, star, name = m.groups()
        if ctype not in _CTYPES:
            raise TypeError("unsupported kernel parameter type %r in %r; "
                            "supported: %s" % (ctype, part.strip(),
                                               ", ".join(sorted(_CTYPES))))
        args.append(Arg(ctype, _CTYPES[ctype][0], bool(star), bool(const),
                        name))
    return args


# ---------------------------------------------------------------- libraries
_lock = threading.Lock()
_libs = {}


def _nvrtc_candidates():
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    out = []
    for root in roots:
        if root:
            out += sorted(glob.glob(os.path.join(root, "lib64",
                                                 "libnvrtc.so*")))
    found = ctypes.util.find_library("nvrtc")
    if found:
        out.append(found)
    return [p for p in out if "builtins" not in os.path.basename(p)]


def _nvrtc():
    with _lock:
        if "nvrtc" not in _libs:
            tried = _nvrtc_candidates()
            for path in tried:
                try:
                    _libs["nvrtc"] = _bind_nvrtc(ctypes.CDLL(path))
                    break
                except OSError:
                    continue
            else:
                raise RtcError(
                    "libnvrtc not found (looked in $CUDA_HOME/lib64, "
                    "/usr/local/cuda/lib64 and the loader's path%s): "
                    "CudaModule needs the CUDA toolkit's NVRTC"
                    % ("; tried %s" % ", ".join(tried) if tried else ""))
        return _libs["nvrtc"]


def _bind_nvrtc(lib):
    P, C, I, S = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                  ctypes.c_size_t)
    sig = {
        "nvrtcVersion": (ctypes.POINTER(I), ctypes.POINTER(I)),
        "nvrtcCreateProgram": (ctypes.POINTER(P), C, C, I, P, P),
        "nvrtcAddNameExpression": (P, C),
        "nvrtcCompileProgram": (P, I, ctypes.POINTER(C)),
        "nvrtcGetProgramLogSize": (P, ctypes.POINTER(S)),
        "nvrtcGetProgramLog": (P, C),
        "nvrtcGetCUBINSize": (P, ctypes.POINTER(S)),
        "nvrtcGetCUBIN": (P, C),
        "nvrtcGetLoweredName": (P, C, ctypes.POINTER(C)),
        "nvrtcDestroyProgram": (ctypes.POINTER(P),),
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), I
    lib.nvrtcGetErrorString.argtypes = [I]
    lib.nvrtcGetErrorString.restype = C
    return lib


def _cuda():
    with _lock:
        if "cuda" not in _libs:
            path = ctypes.util.find_library("cuda") or "libcuda.so.1"
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RtcError("the CUDA driver library (libcuda) cannot be "
                               "loaded: %s" % e) from e
            P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
            sig = {
                "cuInit": (U,),
                "cuDeviceGet": (ctypes.POINTER(I), I),
                "cuDevicePrimaryCtxRetain": (ctypes.POINTER(P), I),
                "cuCtxSetCurrent": (P,),
                "cuModuleLoadData": (ctypes.POINTER(P), P),
                "cuModuleGetFunction": (ctypes.POINTER(P), P, ctypes.c_char_p),
                "cuFuncSetAttribute": (P, I, I),
                "cuLaunchKernel": (P, U, U, U, U, U, U, U, P,
                                   ctypes.POINTER(P), P),
                "cuGetErrorString": (I, ctypes.POINTER(ctypes.c_char_p)),
            }
            for name, argtypes in sig.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = list(argtypes), I
            _check_cu(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
        return _libs["cuda"]


def _check_cu(lib, rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise RtcError("%s: CUDA driver error %d (%s)" % (
            what, rc, (msg.value or b"unknown").decode()))


def _check_nvrtc(lib, rc, what, prog=None):
    if rc != 0:
        log = _program_log(lib, prog) if prog is not None else ""
        raise RtcError("%s: %s%s" % (what,
                                     lib.nvrtcGetErrorString(rc).decode(),
                                     "\n" + log if log else ""))


def _program_log(lib, prog):
    n = ctypes.c_size_t()
    if lib.nvrtcGetProgramLogSize(prog, ctypes.byref(n)) != 0:
        return ""
    buf = ctypes.create_string_buffer(n.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace").strip()


def _compile(source, options, exports):
    """NVRTC: source -> (cubin bytes, {export: lowered name})."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%r)" % name)
        opts = ["--gpu-architecture=%s" % ARCH] + list(options)
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        _check_nvrtc(lib, lib.nvrtcCompileProgram(prog, len(opts), arr),
                     "NVRTC refused the module", prog)
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%r)" % name)
            lowered[name] = out.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _cache_key(source, options, exports):
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor))
    h = hashlib.sha256()
    for part in (source, "\0".join(options), "\0".join(exports), ARCH,
                 "nvrtc %d.%d" % (major.value, minor.value)):
        h.update(part.encode())
        h.update(b"\1")
    return h.hexdigest()


def _write_atomic(path, data):
    tmp = path.with_name("%s.tmp%d.%d" % (path.name, os.getpid(),
                                          threading.get_ident()))
    tmp.write_bytes(data)
    os.replace(tmp, path)


# ------------------------------------------------------------------ modules
class CudaModule:
    """CUDA C++ source compiled at run time (reference: mx.rtc.CudaModule).

    ``options``: NVRTC options added after ``--gpu-architecture=sm_90a``.
    ``exports``: names of kernels that are not ``extern "C"``, as name
    expressions (``"scale<float>"``). After construction ``from_cache``
    says whether the cubin came from ``cache_path`` and ``compile_ms`` how
    long compiling or loading it took on the host clock."""

    def __init__(self, source, options=(), exports=()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        t0 = time.perf_counter()
        key = _cache_key(source, self.options, self.exports)
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        self.cache_path = CACHE_DIR / (key + ".cubin")
        names_path = CACHE_DIR / (key + ".json")
        self.from_cache = self.cache_path.exists() and names_path.exists()
        if self.from_cache:
            self.cubin = self.cache_path.read_bytes()
            self._lowered = json.loads(names_path.read_text())
        else:
            self.cubin, self._lowered = _compile(source, self.options,
                                                 self.exports)
            _write_atomic(self.cache_path, self.cubin)
            _write_atomic(names_path, json.dumps(self._lowered).encode())
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._modules = {}          # device index -> CUmodule
        self._mod_lock = threading.Lock()

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with the parameters of ``signature``."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))

    def _function(self, device, symbol):
        """The CUfunction of ``symbol`` in this module on ``device``, its
        primary context made current on this thread."""
        lib = _cuda()
        with self._mod_lock:
            ctx = _primary_context(lib, device)
            _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
            mod = self._modules.get(device)
            if mod is None:
                mod = ctypes.c_void_p()
                image = ctypes.create_string_buffer(self.cubin,
                                                    len(self.cubin))
                _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod), image),
                          "cuModuleLoadData")
                self._modules[device] = mod
            fn = ctypes.c_void_p()
            _check_cu(lib, lib.cuModuleGetFunction(
                ctypes.byref(fn), mod, symbol.encode()),
                "cuModuleGetFunction(%r)" % symbol)
            return fn


_contexts = {}
_ctx_lock = threading.Lock()


def _primary_context(lib, device):
    """The device's primary context (PyTorch's), retained once."""
    with _ctx_lock:
        ctx = _contexts.get(device)
        if ctx is None:
            dev, ctx = ctypes.c_int(), ctypes.c_void_p()
            _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), device),
                      "cuDeviceGet")
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                        dev),
                      "cuDevicePrimaryCtxRetain")
            _contexts[device] = ctx
        return ctx


_DYNAMIC_SMEM_ATTR = 8   # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_DEFAULT_SMEM = 48 * 1024


class CudaKernel:
    """One kernel of a CudaModule (reference: mx.rtc.CudaKernel)."""

    def __init__(self, module, name, symbol, args):
        self.module, self.name, self.symbol = module, name, symbol
        self.args = args
        self.launches = 0
        self._fns = {}

    def _pack(self, args, device):
        """ctypes holders of the arguments, checked against the
        signature."""
        from .ndarray.ndarray import NDArray
        if len(args) != len(self.args):
            raise ValueError("CudaKernel(%s) takes %d arguments, got %d"
                             % (self.name, len(self.args), len(args)))
        holders = []
        for i, (a, spec) in enumerate(zip(args, self.args)):
            if spec.pointer:
                t = a._t if isinstance(a, NDArray) else a
                if not isinstance(t, torch.Tensor):
                    raise TypeError("CudaKernel(%s): argument %d (%s *) "
                                    "takes an NDArray or a tensor, got %s"
                                    % (self.name, i, spec.ctype, type(a)))
                if t.device != device:
                    raise ValueError("CudaKernel(%s): argument %d is on %s, "
                                     "the launch is on %s"
                                     % (self.name, i, t.device, device))
                if t.dtype != spec.dtype:
                    raise TypeError("CudaKernel(%s): argument %d is %s, the "
                                    "signature says %s *"
                                    % (self.name, i, t.dtype, spec.ctype))
                if not t.is_contiguous():
                    raise ValueError("CudaKernel(%s): argument %d is not "
                                     "contiguous" % (self.name, i))
                holders.append(ctypes.c_void_p(t.data_ptr()))
            else:
                holders.append(_value(self.name, i, a, spec))
        return holders

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``grid_dims`` and
        ``block_dims`` (3 ints each) and ``shared_mem`` bytes of dynamic
        shared memory, on PyTorch's current stream of that device."""
        device = torch.device(ctx) if isinstance(ctx, str) else ctx
        if not isinstance(device, torch.device) or device.type != "cuda":
            raise ValueError("CudaKernel(%s).launch: ctx must be a GPU "
                             "context, got %s" % (self.name, ctx))
        device = resolve_device(device)
        grid_dims, block_dims = tuple(grid_dims), tuple(block_dims)
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError("grid_dims and block_dims must be 3 integers "
                             "each, got %s and %s" % (grid_dims, block_dims))
        holders = self._pack(args, device)
        lib = _cuda()
        fn = self._fns.get(device.index)
        if fn is None:
            fn = self.module._function(device.index, self.symbol)
            self._fns[device.index] = fn
        else:
            _check_cu(lib, lib.cuCtxSetCurrent(
                _primary_context(lib, device.index)), "cuCtxSetCurrent")
        if shared_mem > _DEFAULT_SMEM:
            _check_cu(lib, lib.cuFuncSetAttribute(
                fn, _DYNAMIC_SMEM_ATTR, int(shared_mem)),
                "cuFuncSetAttribute(%s, %d bytes)" % (self.name, shared_mem))
        params = (ctypes.c_void_p * len(holders))(
            *[ctypes.addressof(h) for h in holders])
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_cu(lib, lib.cuLaunchKernel(
            fn, *map(int, grid_dims), *map(int, block_dims),
            int(shared_mem), ctypes.c_void_p(stream), params, None),
            "cuLaunchKernel(%s)" % self.name)
        _build.count_launch(self)


def _value(kernel, i, a, spec):
    """A value argument packed as its C type."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or not np.isscalar(a):
        raise TypeError("CudaKernel(%s): argument %d (%s) takes a number, "
                        "got %s" % (kernel, i, spec.ctype, type(a)))
    if spec.ctype == "__nv_bfloat16":
        bits = torch.tensor(float(a), dtype=torch.bfloat16) \
            .view(torch.int16).item() & 0xFFFF
        return ctypes.c_uint16(bits)
    np_type = _CTYPES[spec.ctype][1]
    v = np.array(a, dtype=np_type)
    if np_type == np.float16:
        return ctypes.c_uint16(int(v.view(np.uint16)))
    return _CT[np_type](v.item())


_CT = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
       np.uint8: ctypes.c_uint8, np.int32: ctypes.c_int32,
       np.int8: ctypes.c_int8, np.int64: ctypes.c_int64}


def _pallas_raise(*_a, **_k):
    raise NotImplementedError(
        "Pallas kernels do not run on the H100: use mx.rtc.CudaModule, the "
        "same runtime-compilation flow with CUDA C++ source (NVRTC, sm_90a)")


class PallasModule:
    """Raises: the JAX package's runtime-compiled Pallas source has no
    counterpart on the card; ``CudaModule`` is the flow here."""

    __init__ = _pallas_raise


class PallasKernel:
    """Raises, as ``PallasModule`` does."""

    __init__ = _pallas_raise
