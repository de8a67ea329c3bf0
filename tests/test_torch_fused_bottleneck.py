"""The PyTorch port's fused stage-1 bottleneck against the JAX package's.

The plain version (``bottleneck_reference``, which the wrapper takes for CPU
tensors) is held to the JAX package's Pallas kernel in interpret mode and to
its XLA conv-stack reference at tests/test_pallas.py's fp32 shape and
tolerance (1e-5), and at a ragged shape. In bf16 both packages round h1, h2
and the output to bf16 at the same places from fp32 sums taken in other
orders, so a value may land one bf16 step apart: bf16 is held within
2 * 2**-8 of the output's largest magnitude. The CUDA kernel itself is
held to the plain version on the card (tests/test_torch_kernels_cuda.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu_torch.ops.kernels import WRAPPERS

# the packages export functions of the modules' own names
jfb = importlib.import_module(
    "incubator_mxnet_tpu.ops.pallas.fused_bottleneck")
tfb = importlib.import_module(
    "incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck")


def _inputs(B, H, W, C, M, seed=0, scale=0.2):
    """tests/test_pallas.py's draws: x, w1, w2, w3, then (s, b) per BN."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32) * 0.5
    w1 = rng.randn(C, M).astype(np.float32) * scale
    w2 = rng.randn(9, M, M).astype(np.float32) * scale
    w3 = rng.randn(M, C).astype(np.float32) * scale

    def mkv(n):
        return (rng.rand(n).astype(np.float32) + 0.5,
                rng.randn(n).astype(np.float32) * 0.1)
    (s1, b1), (s2, b2), (s3, b3) = mkv(M), mkv(M), mkv(C)
    return x, w1, s1, b1, w2, s2, b2, w3, s3, b3


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 8), (1, 5, 7, 12, 3)],
                         ids=["test_pallas", "ragged"])
def test_plain_version_matches_jax_fp32(shape):
    arrays = _inputs(*shape)
    jargs = [jnp.asarray(a) for a in arrays]
    pallas = np.asarray(jfb.fused_bottleneck(*jargs, interpret=True))
    xla = np.asarray(jfb.bottleneck_reference(*jargs))
    got = tfb.fused_bottleneck(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.float32 and got.shape == shape[:4]
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-5)


def test_plain_version_matches_jax_bf16():
    """bench_fused_block's dtypes: x and the weights bf16, s and b fp32."""
    arrays = _inputs(2, 8, 8, 32, 8, seed=3)
    bf = [i in (0, 1, 4, 7) for i in range(10)]
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if b else jnp.asarray(a)
             for a, b in zip(arrays, bf)]
    want = np.asarray(jfb.bottleneck_reference(*jargs).astype(jnp.float32))
    targs = [torch.from_numpy(a).to(torch.bfloat16) if b
             else torch.from_numpy(a) for a, b in zip(arrays, bf)]
    got = tfb.fused_bottleneck(*targs)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 * 2 ** -8 * np.abs(want).max()


def test_cpu_call_does_not_launch_and_is_registered():
    assert WRAPPERS["fused_bottleneck"] is tfb.fused_bottleneck
    n0 = tfb.fused_bottleneck.launches
    tfb.fused_bottleneck(*(torch.from_numpy(a)
                           for a in _inputs(1, 4, 4, 8, 2)))
    assert tfb.fused_bottleneck.launches == n0


@pytest.mark.parametrize("dtype,C,M,ptrs,route", [
    (torch.float32, 256, 64, [0, 16, 32, 48, 64], "fp32"),
    (torch.float32, 5, 63, [2, 4, 6, 8, 10], "fp32"),
    (torch.bfloat16, 256, 64, [0, 16, 32, 48, 64], "bf16"),
    (torch.bfloat16, 304, 8, [0, 16, 32, 48, 64], "bf16"),
    (torch.bfloat16, 300, 8, [0, 16, 32, 48, 64], "bf16_scalar"),
    (torch.bfloat16, 5, 64, [0, 16, 32, 48, 64], "bf16_scalar"),
    (torch.bfloat16, 256, 63, [0, 16, 32, 48, 64], "bf16_scalar"),
    (torch.bfloat16, 256, 64, [2, 16, 32, 48, 64], "bf16_scalar"),
    (torch.bfloat16, 256, 64, [0, 16, 32, 48, 72], "bf16_scalar")])
def test_route_follows_dtype_alignment_and_widths(dtype, C, M, ptrs, route):
    """fp32 keeps its CUDA-core kernel; bf16 takes the tensor-core kernel
    with 16-byte loads when x, w1, w2, w3 and the output start on 16-byte
    boundaries and C and M are multiples of 8, else element-wise loads."""
    assert tfb._route(dtype, C, M, ptrs) == route
    assert tfb.ROUTES[route] in (0, 1, 2)
