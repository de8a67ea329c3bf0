"""The PyTorch port's LayerNorm and row softmax against the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX side runs
the Pallas kernels in interpret mode (as tests/test_pallas.py does) where
they tile, and the JAX package's own jnp path where they do not (odd row
counts). Both sides get the same numpy inputs from a seed. Tolerance
rtol = atol = 1e-5: fp32 on both sides, sums taken in another order.
Gradients go through the port's autograd Functions (plain PyTorch
backwards written as the JAX package's ``_ln_bwd`` and ``_softmax_bwd``)
and through ``jax.vjp`` of the Pallas kernels' custom VJPs.

The CUDA kernels are held against the plain versions on a card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops.pallas import fused_layer_norm, fused_softmax
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops.kernels import fused_norm

RTOL = ATOL = 1e-5


def _ln_inputs(rows, C, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, C) * 2 + 0.5).astype(np.float32)
    g = (rs.rand(C) + 0.5).astype(np.float32)
    b = rs.randn(C).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("rows,C", [(8, 128), (32, 768), (24, 100)])
def test_layer_norm_matches_pallas_interpret(rows, C):
    x, g, b = _ln_inputs(rows, C, rows + C)
    want = np.asarray(fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), eps=1e-5,
                                       interpret=True))
    got = fused_norm.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(b), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows", [1, 7, 33])
def test_layer_norm_odd_rows_match_jax_op(rows):
    """Row counts the Pallas kernel refuses (it needs rows % 8 == 0) go
    through the JAX package's jnp path; the port's kernel takes any count."""
    x, g, b = _ln_inputs(rows, 64, rows)
    assert fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                            jnp.asarray(b), interpret=True) is None
    want = np.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), eps=1e-5))
    got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_layer_norm_on_a_middle_axis_matches_jax_op():
    rs = np.random.RandomState(3)
    x = rs.randn(3, 16, 5).astype(np.float32)
    g = (rs.rand(16) + 0.5).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    want = np.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), axis=1, eps=1e-5))
    got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), axis=1, eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(8, 128), (8, 4, 128), (16, 33)])
def test_softmax_matches_pallas_interpret(shape):
    x = (np.random.RandomState(len(shape)).randn(*shape) * 3) \
        .astype(np.float32)
    want = np.asarray(fused_softmax(jnp.asarray(x), interpret=True))
    got = fused_norm.softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_softmax_minus_inf_rows_match_jax():
    """A partly -inf row gives exact 0 there; a row that is all -inf gives
    what jax.nn.softmax gives (NaN), in the Pallas kernel and the port."""
    x = np.random.RandomState(5).randn(8, 16).astype(np.float32)
    x[1, 3:9] = -np.inf
    x[4, :] = -np.inf
    want = np.asarray(fused_softmax(jnp.asarray(x), interpret=True))
    got = fused_norm.softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[1, 3:9] == 0).all()
    assert np.isnan(got[4]).all() and np.isnan(want[4]).all()
    assert np.isfinite(np.delete(got, 4, axis=0)).all()


@pytest.mark.parametrize("rows", [3, 5])
def test_softmax_odd_rows_and_options_match_jax_op(rows):
    """Odd row counts, temperature and the length mask against the JAX
    package's softmax op (its jnp path on the CPU)."""
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, 4, 10).astype(np.float32)
    length = rs.randint(1, 11, rows).astype(np.int32)
    want = np.asarray(jnn.softmax(jnp.asarray(x), axis=-1, temperature=2.0,
                                  length=jnp.asarray(length),
                                  use_length=True))
    got = tnn.softmax(torch.from_numpy(x), axis=-1, temperature=2.0,
                      length=torch.from_numpy(length), use_length=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want1 = np.asarray(jnn.softmax(jnp.asarray(x), axis=1))
    got1 = tnn.softmax(torch.from_numpy(x), axis=1).numpy()
    np.testing.assert_allclose(got1, want1, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,C", [(8, 128), (32, 768), (24, 100)])
def test_layer_norm_gradients_match_pallas_interpret(rows, C):
    """dx, dgamma and dbeta of the port's autograd Function against the
    JAX custom VJP around the Pallas kernel."""
    x, g, b = _ln_inputs(rows, C, rows + C + 1)
    ct = np.random.RandomState(rows).randn(rows, C).astype(np.float32)
    _, vjp = jax.vjp(lambda x, g, b: fused_layer_norm(x, g, b, eps=1e-5,
                                                      interpret=True),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    fused_norm.layer_norm(*leaves, eps=1e-5).backward(torch.from_numpy(ct))
    for name, t, w in zip(("dx", "dgamma", "dbeta"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", [(8, 128), (8, 4, 128), (16, 33)])
def test_softmax_gradient_matches_pallas_interpret(shape):
    rs = np.random.RandomState(len(shape) + 10)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    ct = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: fused_softmax(x, interpret=True),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    fused_norm.softmax(xt).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_inputs_without_grad_skip_the_autograd_function():
    """Inference keeps the plain call: no graph node, the same values."""
    x = torch.randn(4, 32)
    g, b = torch.ones(32), torch.zeros(32)
    assert fused_norm.layer_norm(x, g, b).grad_fn is None
    assert fused_norm.softmax(x).grad_fn is None
    xg = x.clone().requires_grad_()
    y = fused_norm.layer_norm(xg, g, b)
    assert y.grad_fn is not None
    assert torch.equal(y.detach(), fused_norm.layer_norm(x, g, b))
    with torch.no_grad():
        assert fused_norm.softmax(xg).grad_fn is None


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = (fused_norm.layer_norm.launches, fused_norm.softmax.launches)
    x = torch.randn(4, 32)
    fused_norm.layer_norm(x, torch.ones(32), torch.zeros(32))
    fused_norm.softmax(x)
    assert (fused_norm.layer_norm.launches,
            fused_norm.softmax.launches) == before


def test_launch_counts_lose_no_update_across_threads():
    """Batchers of several models launch from their own threads; the
    counts they share must add up."""
    import sys
    import threading
    from incubator_mxnet_tpu_torch.ops.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_norm.layer_norm(x, x[0], x[0])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_norm.softmax(x)


@pytest.mark.parametrize("C,ptrs,route", [
    (768, (0, 16, 32, 48), "warp"), (768, (256,) * 4, "warp"),
    (1024, (0,) * 4, "warp"), (100, (0,) * 4, "warp"),
    (64, (0,) * 4, "warp"), (1000, (0,) * 4, "warp"), (4, (0,) * 4, "warp"),
    (768, (4, 0, 0, 0), "warp_scalar"), (768, (0, 0, 0, 8), "warp_scalar"),
    (768, (0, 1, 0, 0), "warp_scalar"), (769, (0,) * 4, "warp_scalar"),
    (1023, (0,) * 4, "warp_scalar"), (1, (0,) * 4, "warp_scalar"),
    (1025, (0,) * 4, "long"), (3000, (4,) * 4, "long"),
    (4096, (0,) * 4, "long")])
def test_layer_norm_route_follows_c_and_alignment(C, ptrs, route):
    """The LayerNorm kernel's route: rows of up to 1024 values in a warp's
    registers, with 16-byte accesses when C % 4 == 0 and x, gamma, beta and
    the output all start on 16-byte boundaries, else single floats; a block
    a row, read once a pass, above 1024 values."""
    assert fused_norm._route(C, *ptrs) == route
    assert fused_norm.ROUTES[route] in range(3)


#: the 16-bit softmax route of rows of C at 16-byte aligned bases
SOFTMAX_ALIGNED = {1: "scalar", 7: "scalar", 8: "vec", 128: "vec",
                   136: "vec", 1024: "vec", 1025: "long"}


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("ptrs", [(0, 16), (4096, 4096 + 256), (2, 16),
                                  (0, 18), (8, 8)],
                         ids=["aligned", "aligned_far", "x_off", "y_off",
                              "both_off"])
@pytest.mark.parametrize("C", sorted(SOFTMAX_ALIGNED))
def test_softmax_route_follows_c_alignment_and_element_size(C, ptrs,
                                                            elem_bytes):
    """The softmax kernel's route: ``vec`` (16-byte vectors of 8 values)
    only for 2-byte elements, C <= 1024 a multiple of 8 and both bases on
    16-byte boundaries; else ``scalar`` up to 1024 values and ``long``
    above. fp32 has no vec kernel: its rows are scalar or long."""
    route = fused_norm._softmax_route(C, *ptrs, elem_bytes)
    want = SOFTMAX_ALIGNED[C]
    if want == "vec" and (elem_bytes == 4 or ptrs[0] % 16 or ptrs[1] % 16):
        want = "scalar"
    assert route == want
    assert fused_norm.SOFTMAX_ROUTES[route] in range(3)


# ------------------------------------------------------------- bf16, fp16
# Under the JAX trainer's compute_dtype the kernels take bf16 or fp16 x (and
# gamma, beta) and compute in fp32, writing o_ref's dtype (fused_norm.py:
# 51-59, :127-131). The Pallas kernels run here in interpret mode on one
# block of every row (33 rows do not tile the TPU's way; interpret mode does
# not care). Each element within twice the dtype's half step (2**-8 in
# bf16, 2**-11 in fp16) of the output's largest magnitude, and at least
# 99 % of the elements bitwise equal: both round once, to nearest even,
# from fp32 arithmetic summed in other orders (all of them are, at these
# shapes). In fp16 the padding rows' -1e30 is -inf, on both sides.
#: dtype name -> (torch dtype, jnp dtype, the tolerance's share of the max)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
        "float16": (torch.float16, jnp.float16, 2.0 ** -11)}


def _pallas_rows(kernel, args, rows, C, jdt):
    from jax.experimental import pallas as pl
    specs = [pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)
             for a in args]
    return pl.pallas_call(
        kernel, grid=(1,), in_specs=specs,
        out_specs=pl.BlockSpec((rows, C), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, C), jdt),
        interpret=True)(*args)


def _half_agree(got, want, rel):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= rel, err
    assert float((got == want).mean()) >= 0.99


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("rows", [8, 33, 256])
@pytest.mark.parametrize("C", [768, 771])
def test_half_layer_norm_matches_pallas_interpret(rows, C, dtype):
    import functools
    from incubator_mxnet_tpu.ops.pallas.fused_norm import _ln_kernel
    tdt, jdt, rel = HALF[dtype]
    x, g, b = (torch.from_numpy(a).to(tdt)
               for a in _ln_inputs(rows, C, rows + C))
    jx, jg, jb = (jnp.asarray(t.float().numpy(), jdt) for t in (x, g, b))
    want = _pallas_rows(functools.partial(_ln_kernel, eps=1e-5),
                        (jx, jg.reshape(1, C), jb.reshape(1, C)), rows, C,
                        jdt)
    got = tnn.layer_norm(x, g, b, eps=1e-5)
    assert got.dtype == tdt
    _half_agree(got, want, rel)


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("rows", [8, 33, 256])
@pytest.mark.parametrize("C", [768, 771])
def test_half_softmax_matches_pallas_interpret(rows, C, dtype):
    from incubator_mxnet_tpu.ops.pallas.fused_norm import _softmax_kernel
    tdt, jdt, rel = HALF[dtype]
    rs = np.random.RandomState(rows * C)
    x = (3 * rs.randn(rows, C)).astype(np.float32)
    x[::3, C // 2:] = -1e30                 # the padding bias's rows
    xt = torch.from_numpy(x).to(tdt)
    want = _pallas_rows(_softmax_kernel,
                        (jnp.asarray(xt.float().numpy(), jdt),), rows, C,
                        jdt)
    got = tnn.softmax(xt, axis=-1)
    assert got.dtype == tdt
    _half_agree(got, want, rel)


def test_fp16_softmax_keeps_subnormal_probabilities_as_pallas_does():
    """A probability below 2**-14 is an fp16 subnormal on both sides (no
    flush to zero), and one past the range cannot occur; LayerNorm's output
    past 65504 rounds to inf on both sides (no saturation)."""
    import functools
    from incubator_mxnet_tpu.ops.pallas.fused_norm import (_ln_kernel,
                                                           _softmax_kernel)
    x = np.zeros((8, 128), np.float32)
    x[:, 0] = 12.0                          # the rest get ~6e-6 each
    xt = torch.from_numpy(x).half()
    got = tnn.softmax(xt, axis=-1)
    want = _pallas_rows(_softmax_kernel, (jnp.asarray(x, jnp.float16),), 8,
                        128, jnp.float16)
    sub = got[:, 1:].float()
    assert bool(((sub > 0) & (sub < 2.0 ** -14)).all())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    x, g, b = _ln_inputs(8, 128, 3)
    g = np.full_like(g, 60000.0)
    xt, gt, bt = (torch.from_numpy(a).half() for a in (x, g, b))
    got = tnn.layer_norm(xt, gt, bt, eps=1e-5)
    want = _pallas_rows(functools.partial(_ln_kernel, eps=1e-5),
                        (jnp.asarray(x, jnp.float16),
                         jnp.asarray(g, jnp.float16).reshape(1, 128),
                         jnp.asarray(b, jnp.float16).reshape(1, 128)),
                        8, 128, jnp.float16)
    assert bool(torch.isinf(got).any())
    np.testing.assert_array_equal(np.isinf(got.float().numpy()),
                                  np.isinf(np.asarray(want, np.float32)))


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_gradients_keep_the_dtypes_of_the_pallas_vjp(dtype):
    """``_ln_bwd`` and ``_softmax_bwd`` in fp32 from bf16 or fp16
    residuals: dx in x's dtype and dgamma, dbeta in gamma's, as jax.vjp of
    the Pallas kernels gives them, within a step of the dtype (2**-7 in
    bf16, 2**-10 in fp16) of each gradient's largest magnitude."""
    tdt, jdt, rel = HALF[dtype]
    x, g, b = (torch.from_numpy(a).to(tdt).requires_grad_()
               for a in _ln_inputs(16, 128, 5))
    y = tnn.layer_norm(x, g, b)
    (y.float() ** 2).sum().backward()
    jx, jg, jb = (jnp.asarray(t.detach().float().numpy(), jdt)
                  for t in (x, g, b))
    _, vjp = jax.vjp(lambda a, c, d: fused_layer_norm(a, c, d,
                                                      interpret=True),
                     jx, jg, jb)
    jy = fused_layer_norm(jx, jg, jb, interpret=True)
    want = vjp((2 * jy.astype(jnp.float32)).astype(jdt))
    for t, w in zip((x, g, b), want):
        assert t.grad.dtype == tdt and w.dtype == jdt
        err = np.abs(t.grad.float().numpy()
                     - np.asarray(w.astype(jnp.float32))).max()
        assert err <= 2 * rel * np.abs(np.asarray(
            w.astype(jnp.float32))).max()
    s = torch.from_numpy(np.random.RandomState(6).randn(8, 128)
                         .astype(np.float32)).to(tdt).requires_grad_()
    tnn.softmax(s, axis=-1)[:, 0].float().sum().backward()
    assert s.grad.dtype == tdt
