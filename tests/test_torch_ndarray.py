"""The PyTorch port's NDArray and op registry against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX package's
``nd`` and the port's on the CPU: creation, arithmetic with arrays and
scalars (``base ** x`` too), comparison, indexing and assignment, MXNet's
reshape codes 0 and -1 read from either end (``reverse``), reductions, ``astype``, ``copyto``, and the ops the eager gluon path
binds (FullyConnected, Convolution, BatchNorm, Pooling, Activation, Flatten,
softmax, log_softmax, pick). Elementwise results are exact (atol 0); sums,
products and the softmax family within rtol 1e-6 / atol 1e-6 (summation
order). The op table is the JAX package's name for name; an op that is not
ported yet raises NotImplementedError naming ROADMAP Queue 1 item 10.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops.registry import _OP_REGISTRY as JAX_OPS
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.ops import registry

CPU = mx.cpu()
RS = np.random.RandomState(0)
A = RS.randn(3, 4).astype(np.float32)
B = (RS.rand(3, 4) + 0.5).astype(np.float32)


def _pair(x):
    return jmx.nd.array(x), nd.array(x, ctx=CPU)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "radd",
                                "rsub", "rmul", "rdiv", "neg", "abs"])
def test_arithmetic_matches_jax(op):
    (ja, ta), (jb, tb) = _pair(A), _pair(B)
    f = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
         "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
         "pow": lambda a, b: abs(a) ** b, "radd": lambda a, b: 2.5 + a,
         "rsub": lambda a, b: 2.5 - a, "rmul": lambda a, b: a * 3,
         "rdiv": lambda a, b: 1.5 / b, "neg": lambda a, b: -a,
         "abs": lambda a, b: abs(a)}[op]
    want, got = f(ja, jb).asnumpy(), f(ta, tb).asnumpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("base", [2, 0.5, 2.5])
def test_rpow_matches_jax(base):
    """``base ** x`` (the reference's ``__rpow__``; the port had none)."""
    x = np.random.RandomState(5).randn(3, 4, 5).astype(np.float32)
    ja, ta = _pair(x)
    want, got = (base ** ja).asnumpy(), (base ** ta).asnumpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(0, -1), (-1, 0), (0, 0, 5),
                                   (2, -1, 0), (-1,)])
@pytest.mark.parametrize("reverse", [False, True])
def test_reshape_codes_read_from_either_end_match_jax(shape, reverse):
    """``reshape(shape, reverse=...)`` with the codes 0 and -1: the port
    ignored ``reverse`` and gave (3, 20) for (0, -1) on (3, 4, 5)."""
    x = np.random.RandomState(6).randn(3, 4, 5).astype(np.float32)
    ja, ta = _pair(x)
    want = ja.reshape(shape, reverse=reverse).asnumpy()
    got = ta.reshape(shape, reverse=reverse).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if shape == (0, -1) and reverse:
        assert got.shape == (4, 15)


def test_creation_comparison_and_indexing_match_jax():
    for fn in ("zeros", "ones"):
        np.testing.assert_array_equal(getattr(nd, fn)((2, 3), ctx=CPU)
                                      .asnumpy(),
                                      getattr(jmx.nd, fn)((2, 3)).asnumpy())
    np.testing.assert_array_equal(nd.full((2,), 7.5, ctx=CPU).asnumpy(),
                                  jmx.nd.full((2,), 7.5).asnumpy())
    np.testing.assert_array_equal(nd.arange(0, 10, 2, ctx=CPU).asnumpy(),
                                  jmx.nd.arange(0, 10, 2).asnumpy())
    ints = nd.array(np.arange(6), ctx=CPU)
    assert ints.dtype == np.int32 == jmx.nd.array(np.arange(6)).dtype
    assert nd.array([1, 2], ctx=CPU).dtype == np.float32
    (ja, ta), (jb, tb) = _pair(A), _pair(B)
    for f in (lambda a, b: a > b, lambda a, b: a == a, lambda a, b: a <= b):
        np.testing.assert_array_equal(f(ta, tb).asnumpy(),
                                      f(ja, jb).asnumpy())
    for key in (1, slice(1, 3), (1, 2), (slice(None), 2)):
        np.testing.assert_array_equal(ta[key].asnumpy(), ja[key].asnumpy())
    idx = [0, 2]
    np.testing.assert_array_equal(
        ta[nd.array(idx, ctx=CPU, dtype="int32")].asnumpy(),
        ja[jmx.nd.array(idx, dtype="int32")].asnumpy())
    ta[0] = 0.0
    ja[0] = 0.0
    ta[1, 1] = 9.0
    ja[1, 1] = 9.0
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())


def test_reshape_reductions_astype_copyto_match_jax():
    x = RS.rand(3, 4, 5).astype(np.float32)
    ja, ta = _pair(x)
    for shape in ((4, 15), (0, -1), (-1,), (3, 0, 5)):
        assert ta.reshape(shape).shape == ja.reshape(shape).shape
    for f in (lambda a: a.sum(), lambda a: a.sum(axis=1),
              lambda a: a.mean(axis=(0, 2)), lambda a: a.max(axis=0),
              lambda a: a.sum(axis=1, keepdims=True),
              lambda a: a.mean(axis=1, exclude=True), lambda a: a.norm()):
        np.testing.assert_allclose(f(ta).asnumpy(), f(ja).asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    for dt in ("int32", "float16"):
        assert ta.astype(dt).dtype == ja.astype(dt).dtype
        np.testing.assert_array_equal(ta.astype(dt).asnumpy(),
                                      ja.astype(dt).asnumpy())
    dst = nd.zeros((3, 4, 5), ctx=CPU)
    ta.copyto(dst)
    np.testing.assert_array_equal(dst.asnumpy(), x)
    assert ta.copyto(CPU).context == CPU and ta.context == CPU
    assert float(ta[0, 0, 0].asscalar()) == float(x[0, 0, 0])
    assert ta.as_in_context(CPU) is ta
    ta.wait_to_read()
    nd.waitall()
    with pytest.raises(NotImplementedError, match="item 4"):
        ta.reshape(-3, 5)


INT = np.array([[1, 2, 3], [4, 5, 7]], np.int32)


def _typed_pair(x):
    return (jmx.nd.array(x, dtype=x.dtype),
            nd.array(x, ctx=CPU, dtype=x.dtype))


def _same(got, want, rtol=1e-6):
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("x", [A, INT], ids=["float32", "int32"])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_exclude_without_an_axis_reduces_every_axis_as_jax(x, op):
    """ROADMAP Queue 3 item 5: ``exclude`` applies only when an axis is
    given (the reference's ``ops/tensor.py`` ``_reduce``); the port gave
    the array back unreduced. The reference: () holding 8.978549 / 0.748
    (float) and 22 / 3.6666667 (int)."""
    ja, ta = _typed_pair(x)
    f = lambda a: getattr(a, op)(exclude=True)
    _same(f(ta), f(ja))
    assert f(ta).shape == ()
    # axis=() reduces nothing in both packages
    _same(getattr(ta, op)(axis=()), getattr(ja, op)(axis=()))


@pytest.mark.parametrize("op", ["sum", "sum1", "mean", "norm"])
def test_int32_reductions_keep_the_reference_dtypes(op):
    """ROADMAP Queue 3 item 6: on int32 arrays ``sum`` stays int32 (the
    port gave int64), ``mean`` and ``norm`` give float32 (the port
    raised): 22, [6, 16], 3.6666667 and 10.198039."""
    ja, ta = _typed_pair(INT)
    f = {"sum": lambda a: a.sum(), "sum1": lambda a: a.sum(axis=1),
         "mean": lambda a: a.mean(), "norm": lambda a: a.norm()}[op]
    _same(f(ta), f(ja))
    assert f(ta).dtype == (np.int32 if op.startswith("sum") else np.float32)


NEGATIVE_STEPS = [np.s_[::-1], np.s_[::-2, 1::-1], np.s_[..., ::-1],
                  np.s_[1, ::-3], np.s_[None, 2:0:-1, :], np.s_[0:3:-1],
                  np.s_[-1::-1, 3]]


@pytest.mark.parametrize("key", NEGATIVE_STEPS, ids=str)
def test_negative_slice_steps_get_and_set_as_jax(key):
    """ROADMAP Queue 3 item 7: torch indexing refuses a negative slice
    step, jnp indexing takes it; ``x[::-1]`` raised in the port. Reading
    and writing through the same key match the reference."""
    ja, ta = _pair(A)
    _same(ta[key], ja[key], rtol=0)
    value = np.arange(A[key].size, dtype=np.float32).reshape(A[key].shape)
    jb, tb = _pair(A)
    jb[key] = value
    tb[key] = value
    _same(tb, jb, rtol=0)
    jb[key] = 5.0
    tb[key] = 5.0
    _same(tb, jb, rtol=0)


def test_bound_ops_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 6, 6).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32) * 0.2
    b = rs.randn(4).astype(np.float32)
    g, be = (rs.rand(3) + 0.5).astype(np.float32), rs.randn(3).astype(
        np.float32)
    mm, mv = rs.randn(3).astype(np.float32), (rs.rand(3) + 0.5).astype(
        np.float32)
    logits = rs.randn(5, 7).astype(np.float32)
    lab = np.array([0, 6, 3, 2.7, 9], np.float32)    # 2.7 -> 2, 9 clips
    fc_w = rs.randn(4, 108).astype(np.float32)
    cases = [
        ("FullyConnected", (x, fc_w, b), dict(num_hidden=4)),
        ("Convolution", (x, w, b), dict(kernel=(3, 3), stride=(2, 1),
                                        pad=(1, 1), num_filter=4)),
        ("BatchNorm", (x, g, be, mm, mv), dict(eps=1e-5, fix_gamma=False,
                                               training=True)),
        ("BatchNorm", (x, g, be, mm, mv), dict(eps=1e-5, fix_gamma=False)),
        ("Pooling", (x,), dict(kernel=(3, 3), pool_type="max",
                               stride=(2, 2), pad=(1, 1))),
        ("Pooling", (x,), dict(kernel=(1, 1), pool_type="avg",
                               global_pool=True)),
        ("Activation", (x,), dict(act_type="relu")),
        ("Activation", (x,), dict(act_type="softrelu")),
        ("Flatten", (x,), {}),
        ("flatten", (x,), {}),
        ("softmax", (logits,), dict(axis=-1)),
        ("log_softmax", (logits,), dict(axis=0)),
        ("pick", (logits, lab), dict(axis=-1)),
    ]
    for name, args, kw in cases:
        want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in args], **kw)
        got = getattr(nd, name)(*[nd.array(a, ctx=CPU) for a in args], **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want), name
        for a, e in zip(got, want):
            assert isinstance(a, nd.NDArray)
            np.testing.assert_allclose(a.asnumpy(), e.asnumpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    # tensors in, tensors out: the layers' tensor path
    out = nd.Activation(torch.from_numpy(x), act_type="relu")
    assert isinstance(out, torch.Tensor)


def test_op_table_is_the_jax_packages_and_unported_ops_raise():
    assert set(registry.table_names()) == set(JAX_OPS)
    assert registry.list_ops() == sorted({i.name for i in JAX_OPS.values()})
    bound = {"FullyConnected", "Convolution", "BatchNorm", "Pooling",
             "Activation", "Flatten", "softmax", "log_softmax", "pick",
             "Embedding", "RNN", "quantize_v2", "dequantize", "requantize",
             "quantized_fully_connected"}
    assert {n for n in bound if registry.get_op(n)} == bound
    assert registry.get_op("flatten") is registry.get_op("Flatten")
    assert registry.get_op("BatchNorm").num_outputs == 3
    for name in ("dot", "Dropout", "SoftmaxOutput", "concat"):
        assert callable(getattr(nd, name))
        with pytest.raises(NotImplementedError, match="item 10"):
            registry.get_op(name)
        with pytest.raises(NotImplementedError, match="item 10"):
            getattr(nd, name)(nd.zeros((2, 2), ctx=CPU))
    with pytest.raises(KeyError):
        registry.get_op("no_such_op")


def test_ndarray_save_load_crosses_packages(tmp_path):
    x = RS.randn(3, 2).astype(np.float32)
    f = str(tmp_path / "a.npz")
    nd.save(f, {"x": nd.array(x, ctx=CPU), "y": nd.ones((2,), ctx=CPU)})
    back = jmx.nd.load(f)
    np.testing.assert_array_equal(back["x"].asnumpy(), x)
    jmx.nd.save(f, [jmx.nd.array(x)])
    got = nd.load(f)
    assert isinstance(got, list)
    np.testing.assert_array_equal(got[0].numpy(), x)


def test_default_context_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        nd.array([1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        nd.zeros((2,))
