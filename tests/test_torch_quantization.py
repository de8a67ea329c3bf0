"""The PyTorch port's quantization ops and ``Int8Dense`` against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages.
``quantize_v2`` and ``requantize`` codes and ranges are bitwise equal (the
scale is the same float32 division, the rounding half to even in both);
``dequantize`` and ``quantized_fully_connected`` within rtol 1e-6; the
port's ``Int8Dense`` within rtol 1e-6 of the JAX package's, and within the
reference test's 2 % of the output scale of the fp32 product
(``tests/test_serving.py``). ``MXTPU_SERVE_INT8`` is set through
``monkeypatch`` only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.ops import quantization as jq
from incubator_mxnet_tpu_torch import nd, serving
from incubator_mxnet_tpu_torch.ops import quantization as tq
from incubator_mxnet_tpu_torch.ops.registry import get_op

RTOL = 1e-6


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _data(seed, shape, scale=1.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("calib", [None, (-2.5, 1.75)],
                         ids=["minmax", "calibrated"])
@pytest.mark.parametrize("shape,scale", [((5, 16), 1.0), ((8, 650), 0.3),
                                         ((3, 4, 7), 40.0)])
def test_quantize_v2_codes_and_ranges_are_bitwise_jax(calib, shape, scale):
    x = _data(sum(shape), shape, scale)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    jqx, jmin, jmax = jq.quantize_v2(jnp.asarray(x), **kw)
    tqx, tmin, tmax = tq.quantize_v2(torch.from_numpy(x), **kw)
    assert tqx.dtype == torch.int8
    np.testing.assert_array_equal(_np(tqx), np.asarray(jqx))
    assert _np(tmin).tobytes() == np.asarray(jmin, np.float32).tobytes()
    assert _np(tmax).tobytes() == np.asarray(jmax, np.float32).tobytes()


def test_rounding_is_half_to_even_in_both():
    # 127 / amax = 1 here, so every x * scale below is an exact half
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    jqx = np.asarray(jq.quantize_v2(jnp.asarray(x))[0])
    tqx = _np(tq.quantize_v2(torch.from_numpy(x))[0])
    np.testing.assert_array_equal(tqx, [[0, 2, 2, 0, -2, 127]])
    np.testing.assert_array_equal(tqx, jqx)


def test_dequantize_and_requantize_match_jax():
    rs = np.random.RandomState(3)
    codes = rs.randint(-127, 128, (6, 9)).astype(np.int8)
    lo, hi = np.float32(-3.25), np.float32(2.0)
    j = jq.dequantize(jnp.asarray(codes), jnp.asarray(lo), jnp.asarray(hi))
    t = tq.dequantize(torch.from_numpy(codes), torch.tensor(lo),
                      torch.tensor(hi))
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL)

    acc = rs.randint(-200000, 200000, (6, 9)).astype(np.int32)
    for calib in ({}, dict(min_calib_range=-1.5, max_calib_range=0.75)):
        jr = jq.requantize(jnp.asarray(acc), jnp.asarray(lo),
                           jnp.asarray(hi), **calib)
        tr = tq.requantize(torch.from_numpy(acc), torch.tensor(lo),
                           torch.tensor(hi), **calib)
        np.testing.assert_array_equal(_np(tr[0]), np.asarray(jr[0]))
        for a, b in zip(tr[1:], jr[1:]):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_fully_connected_matches_jax(with_bias):
    rs = np.random.RandomState(4)
    x = rs.randn(5, 2, 11).astype(np.float32)         # flattened to (5, 22)
    w = rs.randn(7, 22).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    jx, jxmin, jxmax = jq.quantize_v2(jnp.asarray(x))
    jw, jwmin, jwmax = jq.quantize_v2(jnp.asarray(w))
    jb, jbmin, jbmax = jq.quantize_v2(jnp.asarray(b))
    tx, txmin, txmax = tq.quantize_v2(torch.from_numpy(x))
    tw, twmin, twmax = tq.quantize_v2(torch.from_numpy(w))
    tb, tbmin, tbmax = tq.quantize_v2(torch.from_numpy(b))
    jbias = dict(bias=jb, bias_min=jbmin, bias_max=jbmax) if with_bias \
        else dict(no_bias=True)
    tbias = dict(bias=tb, bias_min=tbmin, bias_max=tbmax) if with_bias \
        else dict(no_bias=True)
    jacc, jlo, jhi = jq.quantized_fully_connected(
        jx, jw, data_min=jxmin, data_max=jxmax, weight_min=jwmin,
        weight_max=jwmax, num_hidden=7, **jbias)
    tacc, tlo, thi = tq.quantized_fully_connected(
        tx, tw, data_min=txmin, data_max=txmax, weight_min=twmin,
        weight_max=twmax, num_hidden=7, **tbias)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(_np(tacc), np.asarray(jacc))
    np.testing.assert_allclose(_np(thi), np.asarray(jhi), rtol=RTOL)
    np.testing.assert_allclose(_np(tlo), np.asarray(jlo), rtol=RTOL)


def test_ops_are_bound_under_the_jax_names_and_aliases():
    for name in ("quantize_v2", "_contrib_quantize_v2", "quantize",
                 "dequantize", "requantize", "quantized_fully_connected",
                 "_contrib_quantized_fully_connected"):
        assert get_op(name).fn is not None
    x = nd.array(_data(9, (4, 6)), ctx="cpu")
    q, lo, hi = nd.quantize(x)
    assert q.dtype == np.int8 and float(hi.asscalar()) > 0
    for name in ("quantized_conv", "quantized_pooling", "quantized_flatten"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            get_op(name)(x)


@pytest.mark.parametrize("rows,inp,out,bias", [(5, 16, 32, True),
                                               (8, 650, 300, True),
                                               (3, 33, 7, False)])
def test_int8_dense_matches_jax_and_the_fp32_product(rows, inp, out, bias):
    rs = np.random.RandomState(rows * inp)
    w = rs.randn(out, inp).astype(np.float32)
    b = rs.randn(out).astype(np.float32) if bias else None
    x = rs.randn(rows, inp).astype(np.float32)
    want = np.asarray(jserving.Int8Dense(w, b)(x))
    head = serving.Int8Dense(w, b, device="cpu")
    got = head(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # the reference test's own bound: the symmetric-127 grid on both
    # operands is ~1 % of the output scale
    ref = x @ w.T + (b if bias else 0)
    assert np.abs(got.numpy() - ref).max() < 0.02 * np.abs(ref).max()
    # the weight is quantized once and kept zero-padded in K
    assert head._qw.shape == (out, inp + (-inp % 16))
    assert (head._qw[:, inp:] == 0).all()


def test_int8_serving_enabled_env(monkeypatch):
    for value, want in (("1", True), ("true", True), ("on", True),
                        ("0", False), ("yes", False)):
        monkeypatch.setenv("MXTPU_SERVE_INT8", value)
        assert serving.int8_serving_enabled() is want
        assert jserving.int8_serving_enabled() is want
    monkeypatch.delenv("MXTPU_SERVE_INT8", raising=False)
    assert not serving.int8_serving_enabled()
    assert not jserving.int8_serving_enabled()
