"""The PyTorch port's fused stage-1 bottleneck against the JAX package's.

The plain version (``bottleneck_reference``, which the wrapper takes for CPU
tensors) is held to the JAX package's Pallas kernel in interpret mode and to
its XLA conv-stack reference at tests/test_pallas.py's fp32 shape and
tolerance (1e-5), and at a ragged shape. In bf16 both packages round h1, h2
and the output to bf16 at the same places from fp32 sums taken in other
orders, so a value may land one bf16 step apart: bf16 is held within
2 * 2**-8 of the output's largest magnitude; fp16 likewise at 2 * 2**-11
(three more mantissa bits), against the Pallas kernel in interpret mode and
the XLA reference, and with an h1 past fp16's 65504, which becomes inf
(and NaN after a zero weight) at the same places in both packages. The
CUDA kernel itself is
held to the plain version on the card (tests/test_torch_kernels_cuda.py).
The fp32 kernel's numerical method (3xTF32 products on the tensor cores,
each k-step into a fresh accumulator) is emulated here on the CPU, with the
tensor cores' truncating sums, at the stage-1 geometry.
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


#: each 16-bit dtype's tolerance: 2 steps of its mantissa at the output's
#: largest magnitude
HALF_TOL = {"bfloat16": 2 * 2 ** -8, "float16": 2 * 2 ** -11}


def _half_args(arrays, dtype):
    """x and the weights in ``dtype`` (JAX and torch), s and b fp32."""
    half = [i in (0, 1, 4, 7) for i in range(10)]
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a).astype(jdt) if h else jnp.asarray(a)
             for a, h in zip(arrays, half)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) if h
             else torch.from_numpy(a) for a, h in zip(arrays, half)]
    return jargs, targs


@pytest.mark.parametrize("dtype", sorted(HALF_TOL))
def test_plain_version_matches_jax_half(dtype):
    """bench_fused_block's dtypes: x and the weights bf16 or fp16, s and b
    fp32; against the XLA reference (both dtypes) and the Pallas kernel in
    interpret mode (fp16)."""
    jargs, targs = _half_args(_inputs(2, 8, 8, 32, 8, seed=3), dtype)
    got = tfb.fused_bottleneck(*targs)
    assert got.dtype == getattr(torch, dtype)
    wants = [jfb.bottleneck_reference(*jargs)]
    if dtype == "float16":
        wants.append(jfb.fused_bottleneck(*jargs, interpret=True))
    for want in wants:
        assert str(want.dtype) == dtype
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= HALF_TOL[dtype] * np.abs(want).max()


def test_fp16_h1_past_65504_is_inf_and_nan_where_jax_has_them():
    """fp16 with bn1's scale of channel 0 at 3e5: h1 passes 65504 there and
    rounds to inf in both packages. w2 reads that channel with weights >= 0
    and one zero (the centre tap into h2's channel 0), so h2 is inf, or NaN
    where the inf meets the zero; w3's first 16 output channels read h2
    with weights >= 0, the others with both signs. The output is NaN and
    inf at the same places as the JAX Pallas kernel's (interpret mode) and
    XLA reference's (62.5 % NaN, 32 % inf), and within 2 * 2**-11 of its
    largest finite magnitude elsewhere."""
    arrays = [a.copy() for a in _inputs(2, 8, 8, 32, 8, seed=5)]
    arrays[2][0] = 3e5                              # s1 of channel 0
    arrays[4][:, 0, :] = np.abs(arrays[4][:, 0, :])
    arrays[4][4, 0, 0] = 0.0                        # w2: centre tap, 0 -> 0
    arrays[7][:, :16] = np.abs(arrays[7][:, :16])
    jargs, targs = _half_args(arrays, "float16")
    got = tfb.fused_bottleneck(*targs).float().numpy()
    assert np.isnan(got).any() and np.isinf(got).any()
    for want in (jfb.fused_bottleneck(*jargs, interpret=True),
                 jfb.bottleneck_reference(*jargs)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.where(np.isinf(got), got, 0),
                                      np.where(np.isinf(want), want, 0))
        fin = np.isfinite(want)
        err = np.abs(got[fin] - want[fin]).max()
        assert err <= HALF_TOL["float16"] * np.abs(want[fin]).max()


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
    (torch.bfloat16, 256, 64, [0, 16, 32, 48, 72], "bf16_scalar"),
    (torch.float16, 256, 64, [0, 16, 32, 48, 64], "fp16"),
    (torch.float16, 304, 8, [0, 16, 32, 48, 64], "fp16"),
    (torch.float16, 300, 8, [0, 16, 32, 48, 64], "fp16_scalar"),
    (torch.float16, 256, 63, [0, 16, 32, 48, 64], "fp16_scalar"),
    (torch.float16, 256, 64, [2, 16, 32, 48, 64], "fp16_scalar")])
def test_route_follows_dtype_alignment_and_widths(dtype, C, M, ptrs, route):
    """fp32 takes its one route whatever the shape and addresses (the C
    entry picks 16-byte or 4-byte copies inside it); bf16 takes the
    tensor-core kernel with 16-byte loads when x, w1, w2, w3 and the output
    start on 16-byte boundaries and C and M are multiples of 8, else
    element-wise loads; fp16 the same kernel's fp16 routes under the same
    conditions."""
    assert tfb._route(dtype, C, M, ptrs) == route
    assert tfb.ROUTES[route] in (0, 1, 2, 3, 4)


# ------------------------------------------- the fp32 kernel's arithmetic
def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero, as the kernel splits (csrc/flash_tf32.cuh: tf32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _ulp24(v):
    """The step of a 24-bit significand at magnitude v (float64)."""
    return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0 ** -126)))
                      - 23)


def _mma(c, a, b):
    """One mma.sync m16n8k8 (tf32 in, fp32 accumulator) on each row: c (R,
    N) plus the 8 products of a (R, 8) and b (8, N), which are exact; as the
    card's tensor cores add them (chip_smoke.py's tc_rounding line), every
    term aligned to the largest and cut toward zero at its 24 bits, and the
    sum cut toward zero at 24 bits of its own."""
    terms = torch.cat([c.double()[:, None, :],
                       a.double()[:, :, None] * b.double()[None, :, :]], 1)
    q = _ulp24(terms.abs().amax(dim=1, keepdim=True))
    s = (torch.trunc(terms / q) * q).sum(dim=1)
    q = torch.maximum(_ulp24(s.abs()), q[:, 0])
    return (torch.trunc(s / q) * q).float()


def test_mma_model_cuts_the_sum_toward_zero():
    """The model's rounding on the cases of chip_smoke.py's tc_rounding
    line, each the result the H100 gives (NVIDIA H100 80GB HBM3): a term
    under one ulp of the largest is cut away toward zero, not rounded."""
    u = 2.0 ** -23

    def one(c, terms):
        a = torch.zeros(1, 8)
        a[0, :len(terms)] = torch.tensor(terms)
        return _mma(torch.tensor([[c]]), a, torch.ones(8, 1)).item()
    assert one(1.0, [-0.125 * u]) == 1.0
    assert one(1.0, [0.75 * u]) == 1.0
    assert one(1.0, [1.5 * u]) == 1.0 + u
    assert one(-1.0, [-0.75 * u]) == -1.0
    assert one(0.0, [1.0, 0.75 * u]) == 1.0
    assert one(1.0, [0.0] + [0.125 * u] * 7) == 1.0
    assert one(0.0, []) == 0.0


def _cut_tf32(x):
    """x cut toward zero to TF32's 10 mantissa bits: how the tensor cores
    read an operand whose low 13 bits are set."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(acc, a, b, group):
    """acc + a @ b as the fp32 kernel computes it: a and b split into hi =
    tf32(v) and lo = v - hi, which the tensor cores read cut to tf32; for
    each `group` of 8-wide k-steps in order, the cross terms hi*lo and
    lo*hi of each k-step, then hi*hi of each, into a fresh accumulator (one
    mma each), added to acc in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _cut_tf32(a - ah), _cut_tf32(b - bh)
    for k0 in range(0, a.shape[1], 8 * group):
        steps = [slice(k, k + 8) for k in range(k0, k0 + 8 * group, 8)]
        t = torch.zeros_like(acc)
        for ks in steps:
            t = _mma(_mma(t, ah[:, ks], bl[ks]), al[:, ks], bh[ks])
        for ks in steps:
            t = _mma(t, ah[:, ks], bh[ks])
        acc = acc + t
    return acc


def _unit(mm, x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The unit through mm(acc, a, b, group) in the kernel's order and
    groups: phase 1 over C in order, one k-step a fresh accumulator; phase 2
    tap by tap (ky * 3 + kx) and phase 3 in passes of 64 output channels,
    two k-steps a fresh accumulator; each BN a multiply and an add rounded on
    their own; h1 padded with 0."""
    B, H, W, C = x.shape
    M = w1.shape[1]
    rows = x.reshape(-1, C)
    zero = rows.new_zeros(rows.shape[0], M)
    h1 = torch.relu(mm(zero, rows, w1, 1) * s1 + b1).reshape(B, H, W, M)
    hp = torch.nn.functional.pad(h1, (0, 0, 1, 1, 1, 1))
    acc = zero
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc = mm(acc, hp[:, ky:ky + H, kx:kx + W].reshape(-1, M), w2[tap], 2)
    h2 = torch.relu(acc * s2 + b2)
    h3 = torch.cat([mm(rows.new_zeros(rows.shape[0], min(64, C - c0)), h2,
                       w3[:, c0:c0 + 64], 2) for c0 in range(0, C, 64)], 1)
    return torch.relu(h3 * s3 + b3 + rows).reshape(B, H, W, C)


def test_3xtf32_with_fresh_accumulators_holds_the_stage1_unit_to_1e4():
    """The fp32 kernel's numerical method, checked on the method and not on
    the kernel (which runs only on a card): bench_fused_block's unit at its
    stage-1 geometry with the batch cut to 1 (56 x 56, C = 256, M = 64; x at
    scale 0.5, weights at 0.05, as its RandomState(0) draws), every product
    in 3xTF32 with the kernel's fresh accumulators (one k-step's three mma
    in phase 1, two k-steps' six in phases 2 and 3) and the tensor cores'
    truncating sums, stays within 1e-4 of the same unit in float64
    (measured ~3e-7), the card's tolerance against the plain version.
    Plain TF32 (one product of the hi halves) misses it."""
    rng = np.random.RandomState(0)

    def mk(*shape, scale=0.05):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    def vec(n):
        return (torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5),
                torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
    B, H, W, C, M = 1, 56, 56, 256, 64
    x = mk(B, H, W, C, scale=0.5)
    w1, (s1, b1) = mk(C, M), vec(M)
    w2, (s2, b2) = mk(9, M, M), vec(M)
    w3, (s3, b3) = mk(M, C), vec(C)
    args = (x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    exact = _unit(lambda acc, a, b, group: acc + a @ b,
                  *(t.double() for t in args))
    got = _unit(_mm_3xtf32, *args)
    assert got.dtype == torch.float32
    err = (got.double() - exact).abs().max().item()
    assert err <= 1e-4, err
    tf32 = _unit(lambda acc, a, b, group: acc + _tf32(a) @ _tf32(b),
                 *args)
    assert (tf32.double() - exact).abs().max().item() > 1e-4
    # the plain version in float32 (the card's oracle) within 1e-4 too
    plain = tfb.bottleneck_reference(*args)
    assert (plain.double() - exact).abs().max().item() <= 1e-4
