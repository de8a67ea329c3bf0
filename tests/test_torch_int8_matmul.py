"""The PyTorch port's int8 x int8 -> int32 matmul (plain version, the path a
CPU tensor takes) against the JAX package's Pallas kernel in interpret mode
and against numpy's int32 product.

Integer sums are exact in any order, so every comparison is exact. JAX's
kernel is fed the shapes its tiling assert admits (``test_pallas.py``'s
(64, 96) x (96, 32) with 32-blocks); the port's takes any shape, and is held
to numpy at the PTB head's decode shapes and ragged ones, at the +-127
extremes. The CUDA kernel itself is held to this plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops.pallas.int8_matmul import \
    int8_matmul as jax_int8_matmul
from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
    K_MAX, int8_matmul, int8_matmul_nk)


def _codes(rs, shape, extremes=False):
    a = rs.randint(-127, 128, shape).astype(np.int8)
    if extremes:
        a.flat[::3] = 127
        a.flat[1::3] = -127
    return a


@pytest.mark.parametrize("M,K,N,bm,bn", [(64, 96, 32, 32, 32),
                                         (128, 650, 256, 64, 128),
                                         (8, 33, 16, 8, 16)])
def test_plain_int8_matmul_equals_the_pallas_kernel(M, K, N, bm, bn):
    rs = np.random.RandomState(M + K + N)
    a, b = _codes(rs, (M, K)), _codes(rs, (K, N))
    want = np.asarray(jax_int8_matmul(jnp.asarray(a), jnp.asarray(b),
                                      block_m=bm, block_n=bn,
                                      interpret=True))
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", [(1, 650, 10000), (8, 650, 37),
                                   (5, 33, 7), (3, 4096, 1)])
@pytest.mark.parametrize("extremes", [False, True],
                         ids=["random", "extremes"])
def test_plain_int8_matmul_equals_numpy_int32(M, K, N, extremes):
    rs = np.random.RandomState(K + N)
    a, b = _codes(rs, (M, K), extremes), _codes(rs, (K, N), extremes)
    want = a.astype(np.int32) @ b.astype(np.int32)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    # the (N, K) entry Int8Dense uses gives the same product
    got_nk = int8_matmul_nk(torch.from_numpy(a),
                                 torch.from_numpy(np.ascontiguousarray(b.T)))
    np.testing.assert_array_equal(got_nk.numpy(), want)


def test_extreme_sums_at_k_max_stay_exact():
    # (-128) * (-128) * K_MAX is the largest sum of the longest contraction
    # the kernel takes: inside int32, and exact in the plain version
    K = K_MAX
    a = np.full((2, K), 127, np.int8)
    a[1] = -128
    w = np.full((3, K), -128, np.int8)
    got = int8_matmul_nk(torch.from_numpy(a), torch.from_numpy(w))
    want = a.astype(np.int64) @ w.astype(np.int64).T
    assert want.max() == 2 ** 31 - 2 ** 14 and want.min() >= -2 ** 31
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_path_does_not_launch_and_refuses_other_devices():
    a = torch.zeros(2, 3, dtype=torch.int8)
    n0 = int8_matmul.launches
    int8_matmul(a, torch.zeros(3, 4, dtype=torch.int8))
    assert int8_matmul.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul_nk(a.to("meta"), torch.zeros(4, 3, dtype=torch.int8,
                                                      device="meta"))


@pytest.mark.parametrize("M,K,a_ptr,w_ptr,route", [
    (1, 656, 0, 0, "small"), (16, 656, 0, 0, "small"),
    (8, 656, 0, 0, "small"), (8, 16, 0, 0, "small"), (8, 4096, 1, 0, "small"),
    (16, 650, 1, 3, "small"), (17, 656, 0, 0, "tma"),
    (17, 656, 16, 4096, "tma"), (17, 650, 0, 0, "bytes"),
    (17, 656, 1, 0, "bytes"), (17, 656, 0, 8, "bytes"),
    (4096, 4096, 256, 512, "tma"), (128, K_MAX, 0, 0, "bytes"),
    (128, K_MAX - K_MAX % 16, 0, 0, "tma"),
    (128, K_MAX - K_MAX % 16, 0, 2, "bytes")])
def test_route_follows_m_alignment_and_k(M, K, a_ptr, w_ptr, route):
    """The wrapper's route: the decode tile (K split over a cluster) up to
    M = 16 whatever the alignment and K; above it wgmma + TMA when both bases are 16-byte aligned and
    K % 16 == 0 (TMA's row stride), else byte-wide loads. K_MAX (131071) is
    odd, so it takes the byte route."""
    im = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.kernels.int8_matmul")
    assert im._route(M, K, a_ptr, w_ptr) == route
    assert im.ROUTES[route] in (0, 1, 2)
