"""The PyTorch port's ``mx.rtc``: CUDA C++ source compiled at run time
(NVRTC, sm_90a) and launched through the driver API, the reference MXNet
``CudaModule`` / ``CudaKernel`` API.

The JAX package's counterpart compiles Pallas source and its ``CudaModule``
raises; the port's ``PallasModule`` raises in turn, naming ``CudaModule``.
Nothing here compiles or launches: this machine has no NVRTC and no card.
The signature parser, the packing of value arguments and the refusals (a
CPU context, CPU arrays, a missing NVRTC) are checked here; compiling,
launching, ``exports`` and the cubin cache are checked on a card in
tests/test_torch_kernels_cuda.py.
"""

import ctypes

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import rtc
from incubator_mxnet_tpu_torch.rtc import Arg, parse_signature


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float alpha",
     [Arg("float", torch.float32, True, True, "x"),
      Arg("float", torch.float32, True, False, "y"),
      Arg("float", torch.float32, False, False, "alpha")]),
    ("const float *, double*, int",
     [Arg("float", torch.float32, True, True, None),
      Arg("double", torch.float64, True, False, None),
      Arg("int", torch.int32, False, False, None)]),
    ("  int8_t  *codes,\n  int64_t n ,__nv_bfloat16 s",
     [Arg("int8_t", torch.int8, True, False, "codes"),
      Arg("int64_t", torch.int64, False, False, "n"),
      Arg("__nv_bfloat16", torch.bfloat16, False, False, "s")]),
])
def test_signature_parser_reads_the_reference_form(sig, want):
    assert parse_signature(sig) == want


@pytest.mark.parametrize("sig,err", [
    ("const *x", ValueError), ("float **x", ValueError),
    ("const float *x, ", ValueError), ("float x y z", ValueError),
    ("unsigned short *x", ValueError), ("size_t n", TypeError),
    ("struct_t *p", TypeError),
])
def test_signature_parser_refuses_what_it_cannot_pass(sig, err):
    with pytest.raises(err):
        parse_signature(sig)


def test_value_arguments_are_packed_as_their_c_type():
    (f, d, i, h, b, u8, i64) = parse_signature(
        "float a, double b, int c, __half d, __nv_bfloat16 e, uint8_t f, "
        "int64_t g")
    assert isinstance(rtc._value("k", 0, 3, f), ctypes.c_float)
    assert rtc._value("k", 0, 0.1, f).value == float(np.float32(0.1))
    assert rtc._value("k", 1, 0.1, d).value == 0.1
    assert rtc._value("k", 2, 7, i).value == 7
    assert rtc._value("k", 3, 1.0, h).value == 0x3C00        # fp16 1.0
    assert rtc._value("k", 4, 1.0, b).value == 0x3F80        # bf16 1.0
    assert rtc._value("k", 4, -2.0, b).value == 0xC000
    assert rtc._value("k", 5, 255, u8).value == 255
    assert rtc._value("k", 6, 2 ** 40, i64).value == 2 ** 40
    with pytest.raises(TypeError, match="number"):
        rtc._value("k", 0, torch.ones(1), f)
    with pytest.raises(TypeError, match="number"):
        rtc._value("k", 0, [1.0], f)


def _kernel(sig="const float *x, float *y, float alpha"):
    """A kernel object with no compiled module behind it: enough for the
    checks that run before anything is loaded."""
    return rtc.CudaKernel(None, "axpy", "axpy", parse_signature(sig))


@pytest.mark.parametrize("ctx", [mx.cpu(), "cpu", torch.device("cpu")])
def test_launch_on_a_cpu_context_raises(ctx):
    k = _kernel()
    x = mx.nd.array(np.ones(4, np.float32), ctx=mx.cpu())
    with pytest.raises(ValueError, match="GPU context"):
        k.launch([x, x, 3.0], ctx, (1, 1, 1), (4, 1, 1))
    assert k.launches == 0


def test_cpu_arrays_and_wrong_arguments_are_refused_before_launch():
    k = _kernel()
    dev = torch.device("cuda", 0)
    x = torch.ones(4)
    with pytest.raises(ValueError, match="is on cpu"):
        k._pack([x, x, 3.0], dev)
    with pytest.raises(ValueError, match="takes 3 arguments"):
        k._pack([x, x], dev)
    with pytest.raises(TypeError, match="NDArray or a tensor"):
        k._pack([np.ones(4, np.float32), x, 3.0], dev)


def test_array_dtype_and_layout_are_checked_against_the_signature():
    k = _kernel()
    dev = torch.device("cpu")     # the device check passes; the rest bites
    x = torch.ones(8)
    assert [h.value for h in k._pack([x, x, 3.0], dev)[:2]] \
        == [x.data_ptr()] * 2
    assert k._pack([mx.nd.array(x, ctx=mx.cpu()), x, 3.0], dev)[0].value \
        is not None
    with pytest.raises(TypeError, match="float64"):
        k._pack([x.double(), x, 3.0], dev)
    with pytest.raises(ValueError, match="contiguous"):
        k._pack([x[::2], x, 3.0], dev)
    with pytest.raises(TypeError, match="number"):
        k._pack([x, x, x], dev)


def test_missing_nvrtc_raises_a_clear_error(monkeypatch):
    monkeypatch.setattr(rtc, "_nvrtc_candidates", lambda: [])
    monkeypatch.setattr(rtc, "_libs", {})
    with pytest.raises(rtc.RtcError, match="libnvrtc not found"):
        rtc.CudaModule('extern "C" __global__ void k() {}')


def test_pallas_module_raises_naming_cuda_module_as_jax_does_the_reverse():
    """Each package refuses the other's kernel language and names its own
    flow: the JAX CudaModule names PallasModule, the port's PallasModule
    and PallasKernel name CudaModule."""
    with pytest.raises(NotImplementedError, match="PallasModule"):
        jmx.rtc.CudaModule('extern "C" __global__ void k() {}')
    with pytest.raises(NotImplementedError, match="CudaModule"):
        mx.rtc.PallasModule("def k(x_ref, o_ref):\n    o_ref[...] = 1\n")
    with pytest.raises(NotImplementedError, match="CudaModule"):
        mx.rtc.PallasKernel(None, "k", False)


def test_rtc_is_exported_and_caches_under_build():
    assert mx.rtc is rtc and "rtc" in mx.__all__
    assert rtc.ARCH == "sm_90a"
    assert rtc.CACHE_DIR.parts[-2:] == ("build", "rtc")
