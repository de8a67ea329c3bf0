"""The JAX package's own tests of the eager surface, run against the PyTorch
port on the CPU.

Taken from tests/test_autograd.py, test_gluon.py, test_gluon_semantics.py,
test_ndarray.py and test_loss_optim_metric.py: the tests that touch only
names this port has, each under its own name, with ``ctx=CPU`` wherever
the original leaves the context to its default (the port's default is
``cuda:0``). The rest of those files wait for the ops, layers and
optimizers of ROADMAP Queue 1 items 4, 5, 6, 10 and 14.
"""

import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()


# ------------------------------------------------------ tests/test_autograd.py
def test_basic_backward():
    x = nd.array([1.0, 2.0, 3.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x
        loss = y.sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy())


def test_head_gradient():
    x = nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = 3 * x
    y.backward(nd.array([10.0, 100.0], ctx=CPU))
    np.testing.assert_allclose(x.grad.asnumpy(), [30.0, 300.0])


def test_grad_req_add():
    x = nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            y = 2 * x
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0, 6.0])


def test_grad_req_write_overwrites():
    x = nd.array([1.0, 2.0], ctx=CPU)
    x.attach_grad()
    for _ in range(3):
        with autograd.record():
            y = 2 * x
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 2.0])


def test_multi_path_accumulation():
    x = nd.array([2.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x + 3 * x  # dy/dx = 2x + 3 = 7
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [7.0])


def test_detach_blocks_grad():
    x = nd.array([2.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x
        z = y.detach() * x  # dz/dx = y = 4
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


def test_is_recording_is_training():
    assert not autograd.is_recording()
    with autograd.record():
        assert autograd.is_recording()
        assert autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
    with autograd.record(train_mode=False):
        assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training()


def test_mark_variables():
    x = nd.array([1.0, 2.0], ctx=CPU)
    g = nd.zeros(2, ctx=CPU)
    autograd.mark_variables([x], [g])
    with autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(g.asnumpy(), [2.0, 4.0])
    assert x.grad is g


def test_retain_graph():
    x = nd.array([2.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x
    y.backward(retain_graph=True)
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0])
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


def test_no_record_no_grad():
    x = nd.array([1.0], ctx=CPU)
    x.attach_grad()
    y = x * 2  # not recorded
    assert y._node is None


def test_second_order_grad():
    x = mx.nd.array(np.array([2.0], np.float32), ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x * x
        g = autograd.grad(y, [x], create_graph=True)[0]      # 3x^2
        z = (g * g).sum()                                    # 9x^4
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [36.0 * 8], rtol=1e-5)


def test_backward_create_graph_grad_buffer_differentiable():
    x = mx.nd.array(np.array([3.0], np.float32), ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x * x
        y.backward(create_graph=True)                        # grad = 3x^2
        h = (x.grad * x).sum()                               # 3x^3
    g = autograd.grad(h, [x])[0]                             # 9x^2
    np.testing.assert_allclose(g.asnumpy(), [81.0], rtol=1e-5)


# -------------------------------------------------------- tests/test_gluon.py
def test_parameter_basics():
    p = gluon.Parameter("weight", shape=(3, 4))
    p.initialize(init=mx.init.One(), ctx=CPU)
    assert p.data().shape == (3, 4)
    assert np.all(p.data().asnumpy() == 1)
    assert p.grad().shape == (3, 4)
    p.set_data(nd.zeros((3, 4), ctx=CPU))
    assert np.all(p.data().asnumpy() == 0)
    p.grad_req = "null"
    assert p.data()._grad is None


def test_parameter_deferred_init():
    p = gluon.Parameter("w", shape=(5, 0), allow_deferred_init=True)
    p.initialize(ctx=CPU)
    with pytest.raises(gluon.DeferredInitializationError):
        p.data()
    p.shape_inferred((5, 7))
    assert p.data().shape == (5, 7)


def test_dense_forward_and_repr():
    layer = nn.Dense(4, in_units=3, use_bias=True)
    layer.initialize(mx.init.One(), ctx=CPU)
    x = nd.ones((2, 3), ctx=CPU)
    out = layer(x)
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 4), 3.0))
    assert "Dense" in repr(layer)


def test_dense_deferred_in_units():
    layer = nn.Dense(4)
    layer.initialize(ctx=CPU)
    out = layer(nd.ones((2, 7), ctx=CPU))
    assert out.shape == (2, 4)
    assert layer.weight.shape == (4, 7)


def test_sequential_and_getitem():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.Dense(4))
    net.initialize(ctx=CPU)
    out = net(nd.ones((2, 5), ctx=CPU))
    assert out.shape == (2, 4)
    assert len(net) == 2
    assert isinstance(net[0], nn.Dense)


def test_name_scopes_unique():
    net1 = nn.Dense(2)
    net2 = nn.Dense(2)
    assert net1.prefix != net2.prefix
    seq = nn.HybridSequential(prefix="model_")
    with seq.name_scope():
        d = nn.Dense(2)
    assert d.prefix.startswith("model_")


def test_collect_params_select():
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(2, in_units=2), nn.BatchNorm(in_channels=2))
    net.initialize(ctx=CPU)
    all_params = net.collect_params()
    assert len(all_params._params) == 6
    only_weight = net.collect_params(".*weight")
    assert all(k.endswith("weight") for k in only_weight.keys())


def test_batchnorm_layer_updates_stats():
    layer = nn.BatchNorm(in_channels=3, momentum=0.5)
    layer.initialize(ctx=CPU)
    x = nd.array(np.random.rand(8, 3, 4, 4).astype(np.float32) + 5.0,
                 ctx=CPU)
    before = layer.running_mean.data().asnumpy().copy()
    with autograd.record():
        layer(x)
    after = layer.running_mean.data().asnumpy()
    assert not np.allclose(before, after)
    # inference doesn't update stats
    before2 = layer.running_mean.data().asnumpy().copy()
    layer(x)
    np.testing.assert_allclose(layer.running_mean.data().asnumpy(), before2)


def test_batchnorm_stats_update_hybridized():
    layer = nn.BatchNorm(in_channels=3, momentum=0.5)
    layer.initialize(ctx=CPU)
    layer.hybridize()
    x = nd.array(np.random.rand(8, 3, 2, 2).astype(np.float32) + 1.0,
                 ctx=CPU)
    before = layer.running_mean.data().asnumpy().copy()
    with autograd.record():
        layer(x)
    after = layer.running_mean.data().asnumpy()
    assert not np.allclose(before, after)


def test_hybridize_consistency_mixed_net():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(),
                nn.Flatten(), nn.Dense(3))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(np.random.rand(2, 3, 8, 8).astype(np.float32), ctx=CPU)
    eager = net(x).asnumpy()
    net.hybridize()
    hybrid = net(x).asnumpy()
    np.testing.assert_allclose(eager, hybrid, rtol=1e-4, atol=1e-5)


def test_trainer_step_updates_params():
    net = nn.Dense(1, in_units=2)
    net.initialize(mx.init.One(), ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    x = nd.array([[1.0, 2.0]], ctx=CPU)
    with autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    w_before = net.weight.data().asnumpy().copy()
    trainer.step(1)
    w_after = net.weight.data().asnumpy()
    assert not np.allclose(w_before, w_after)
    assert trainer.learning_rate == 0.1
    trainer.set_learning_rate(0.01)
    assert trainer.learning_rate == 0.01


def test_training_reduces_loss_mlp():
    np.random.seed(0)
    X = np.random.rand(128, 10).astype(np.float32)
    w_true = np.random.rand(10, 1).astype(np.float32)
    Y = X @ w_true
    net = nn.Dense(1)
    net.initialize(mx.init.Normal(0.1), ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    loss_fn = gluon.loss.L2Loss()
    losses = []
    for _ in range(60):
        with autograd.record():
            out = net(nd.array(X, ctx=CPU))
            loss = loss_fn(out, nd.array(Y, ctx=CPU))
        loss.backward()
        trainer.step(X.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    assert losses[-1] < losses[0] * 0.1


def test_save_load_parameters(tmp_path):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
    net.initialize(ctx=CPU)
    fname = str(tmp_path / "net.params")
    net.save_parameters(fname)
    x = nd.ones((1, 3), ctx=CPU)
    expected = net(x).asnumpy()
    net2 = nn.HybridSequential()
    with net2.name_scope():
        net2.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
    net2.load_parameters(fname, ctx=CPU)
    np.testing.assert_allclose(net2(x).asnumpy(), expected, rtol=1e-6)


def test_load_missing_raises(tmp_path):
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=CPU)
    fname = str(tmp_path / "d.params")
    net.save_parameters(fname)
    bigger = nn.HybridSequential()
    with bigger.name_scope():
        bigger.add(nn.Dense(2, in_units=2), nn.Dense(3, in_units=2))
    with pytest.raises(IOError):
        bigger.load_parameters(fname, ctx=CPU)
    bigger.load_parameters(fname, ctx=CPU, allow_missing=True,
                           ignore_extra=True)


def test_constant_param():
    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.const = self.params.get_constant(
                    "const", np.array([[2.0, 2.0]], dtype=np.float32))

        def hybrid_forward(self, F, x, const):
            return x * const

    net = Net()
    net.initialize(ctx=CPU)
    out = net(nd.ones((1, 2), ctx=CPU))
    np.testing.assert_allclose(out.asnumpy(), [[2, 2]])
    x = nd.ones((1, 2), ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = net(x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [[2, 2]])


def test_shared_params():
    d1 = nn.Dense(4, in_units=4)
    d2 = nn.Dense(4, in_units=4, params=d1.params)
    d1.initialize(ctx=CPU)
    x = nd.array(np.random.rand(2, 4).astype(np.float32), ctx=CPU)
    np.testing.assert_allclose(d1(x).asnumpy(), d2(x).asnumpy())


def test_block_cast():
    net = nn.Dense(3, in_units=2)
    net.initialize(ctx=CPU)
    net.cast("float16")
    assert net.weight.data().dtype == np.float16
    net.cast("float32")
    out = net(nd.ones((1, 2), ctx=CPU))
    assert out.dtype == np.float32


def test_summary_runs(capsys):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3))
    net.initialize(ctx=CPU)
    net.summary(nd.ones((1, 3), ctx=CPU))
    captured = capsys.readouterr()
    assert "Total params" in captured.out


# ----------------------------------------------- tests/test_gluon_semantics.py
def test_deferred_init_infers_in_units():
    net = gluon.nn.Dense(8)              # in_units unknown
    net.initialize(mx.init.Xavier(), ctx=CPU)     # deferred
    x = mx.nd.array(np.random.rand(4, 5).astype(np.float32), ctx=CPU)
    out = net(x)
    assert out.shape == (4, 8)
    assert net.weight.shape == (8, 5)


def test_deferred_init_error_before_forward():
    net = gluon.nn.Dense(8)
    net.initialize(ctx=CPU)
    with pytest.raises(Exception):
        net.weight.data()                # shape still unknown


def test_shared_params_between_blocks():
    shared = gluon.nn.Dense(6)
    shared.initialize(mx.init.Xavier(), ctx=CPU)
    x = mx.nd.array(np.random.rand(2, 3).astype(np.float32), ctx=CPU)
    shared(x)
    tied = gluon.nn.Dense(6, params=shared.collect_params())
    out1 = shared(x).asnumpy()
    out2 = tied(x).asnumpy()
    np.testing.assert_allclose(out1, out2, rtol=1e-6)
    # updating one updates the other
    shared.weight.set_data(mx.nd.zeros(shared.weight.shape, ctx=CPU))
    np.testing.assert_allclose(tied(x).asnumpy(),
                               np.broadcast_to(
                                   shared.bias.data().asnumpy(), (2, 6)),
                               rtol=1e-5, atol=1e-6)


def test_name_scope_unique_prefixes():
    net1 = gluon.nn.Dense(2)
    net2 = gluon.nn.Dense(2)
    assert net1.weight.name != net2.weight.name


def test_grad_req_null_params_not_updated():
    net = gluon.nn.Dense(4)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = mx.nd.array(np.random.rand(2, 3).astype(np.float32), ctx=CPU)
    net(x)
    net.weight.grad_req = "null"
    before = net.weight.data().asnumpy().copy()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5})
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)
    np.testing.assert_allclose(net.weight.data().asnumpy(), before)
    # bias still trains
    assert np.abs(net.bias.data().asnumpy()).sum() > 0


def test_grad_add_accumulates():
    x = mx.nd.array(np.ones(3, np.float32), ctx=CPU)
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            y = (x * x).sum()
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 6.0)   # 3 * 2x


def test_block_children_iteration_and_repr():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4), gluon.nn.Dense(2))
    assert len(list(net._children.values())) == 2
    params = net.collect_params()
    assert len(params) == 4              # 2 weights + 2 biases


def test_hybridize_shape_change_retriggers_trace():
    net = gluon.nn.Dense(4)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.hybridize()
    out1 = net(mx.nd.array(np.random.rand(2, 3).astype(np.float32),
                           ctx=CPU))
    out2 = net(mx.nd.array(np.random.rand(5, 3).astype(np.float32),
                           ctx=CPU))
    assert out1.shape == (2, 4) and out2.shape == (5, 4)


def test_constant_parameter():
    class WithConst(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.const = self.params.get_constant(
                    "const", np.array([1.0, 2.0], np.float32))

        def hybrid_forward(self, F, x, const):
            return x * const

    net = WithConst()
    net.initialize(ctx=CPU)
    out = net(mx.nd.array(np.ones((3, 2), np.float32), ctx=CPU))
    np.testing.assert_allclose(out.asnumpy(), [[1, 2]] * 3)


# ------------------------------------------------------ tests/test_ndarray.py
def test_creation():
    a = nd.array([[1, 2], [3, 4]], ctx=CPU)
    assert a.shape == (2, 2)
    assert a.dtype == np.float32
    assert a.size == 4
    assert a.ndim == 2
    z = nd.zeros((3, 4), ctx=CPU)
    assert np.all(z.asnumpy() == 0)
    o = nd.ones((2, 2), ctx=CPU, dtype="int32")
    assert o.asnumpy().dtype == np.int32
    f = nd.full((2, 2), 7.5, ctx=CPU)
    assert np.all(f.asnumpy() == 7.5)
    r = nd.arange(0, 10, 2, ctx=CPU)
    np.testing.assert_array_equal(r.asnumpy(), [0, 2, 4, 6, 8])


def test_arithmetic():
    a = nd.array([[1.0, 2.0], [3.0, 4.0]], ctx=CPU)
    b = nd.array([[5.0, 6.0], [7.0, 8.0]], ctx=CPU)
    np.testing.assert_allclose((a + b).asnumpy(), [[6, 8], [10, 12]])
    np.testing.assert_allclose((a - b).asnumpy(), [[-4, -4], [-4, -4]])
    np.testing.assert_allclose((a * b).asnumpy(), [[5, 12], [21, 32]])
    np.testing.assert_allclose((b / a).asnumpy(), [[5, 3], [7 / 3, 2]],
                               rtol=1e-6)
    np.testing.assert_allclose((a + 1).asnumpy(), [[2, 3], [4, 5]])
    np.testing.assert_allclose((2 - a).asnumpy(), [[1, 0], [-1, -2]])
    np.testing.assert_allclose((a ** 2).asnumpy(), [[1, 4], [9, 16]])
    np.testing.assert_allclose((-a).asnumpy(), [[-1, -2], [-3, -4]])
    np.testing.assert_allclose(abs(nd.array([-1.0, 2.0], ctx=CPU))
                               .asnumpy(), [1, 2])


def test_inplace_ops():
    a = nd.array([1.0, 2.0], ctx=CPU)
    a += 1
    np.testing.assert_allclose(a.asnumpy(), [2, 3])
    a *= 2
    np.testing.assert_allclose(a.asnumpy(), [4, 6])


def test_comparison():
    a = nd.array([1.0, 2.0, 3.0], ctx=CPU)
    b = nd.array([2.0, 2.0, 2.0], ctx=CPU)
    np.testing.assert_array_equal((a > b).asnumpy(), [0, 0, 1])
    np.testing.assert_array_equal((a == b).asnumpy(), [0, 1, 0])
    np.testing.assert_array_equal((a <= b).asnumpy(), [1, 1, 0])


def test_indexing():
    a = nd.array(np.arange(24).reshape(4, 6), ctx=CPU)
    np.testing.assert_array_equal(a[1].asnumpy(), np.arange(6) + 6)
    np.testing.assert_array_equal(a[1:3].asnumpy(),
                                  np.arange(24).reshape(4, 6)[1:3])
    np.testing.assert_array_equal(a[1, 2].asnumpy(), 8)
    idx = nd.array([0, 2], ctx=CPU, dtype="int32")
    np.testing.assert_array_equal(a[idx].asnumpy(),
                                  np.arange(24).reshape(4, 6)[[0, 2]])
    a[0] = 0.0
    assert np.all(a.asnumpy()[0] == 0)
    a[1, 1] = 99.0
    assert a.asnumpy()[1, 1] == 99


def test_waitall_and_wait_to_read():
    a = nd.ones((10, 10), ctx=CPU)
    b = a * 2
    b.wait_to_read()
    nd.waitall()
    assert b.asnumpy()[0, 0] == 2


# ---------------------------------------------- tests/test_loss_optim_metric.py
def test_l2_l1_loss():
    pred = nd.array([[1.0, 2.0]], ctx=CPU)
    label = nd.array([[2.0, 4.0]], ctx=CPU)
    l2 = gluon.loss.L2Loss()(pred, label)
    np.testing.assert_allclose(l2.asnumpy(), [(1 + 4) / 2 / 2], rtol=1e-5)
    l1 = gluon.loss.L1Loss()(pred, label)
    np.testing.assert_allclose(l1.asnumpy(), [1.5], rtol=1e-5)


def test_softmax_ce_loss():
    pred = nd.array(np.random.rand(4, 5).astype(np.float32), ctx=CPU)
    label = nd.array([0, 1, 2, 3], ctx=CPU, dtype="float32")
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label)
    p = pred.asnumpy()
    logp = p - p.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    ref = -logp[np.arange(4), [0, 1, 2, 3]]
    np.testing.assert_allclose(loss.asnumpy(), ref, rtol=1e-4)
    # dense label
    onehot = np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]
    loss_d = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        pred, nd.array(onehot, ctx=CPU))
    np.testing.assert_allclose(loss_d.asnumpy(), ref, rtol=1e-4)


def _run_opt(name, kwargs, steps=3):
    w = nd.array(np.array([1.0, -2.0, 3.0], np.float32), ctx=CPU)
    opt = mx.optimizer.create(name, **kwargs)
    state = opt.create_state(0, w)
    for _ in range(steps):
        g = nd.array(np.array([0.1, -0.2, 0.3], np.float32), ctx=CPU)
        opt.update(0, w, g, state)
    return w.asnumpy()


def test_sgd_matches_reference_formula():
    out = _run_opt("sgd", {"learning_rate": 0.1}, steps=1)
    np.testing.assert_allclose(out, [1 - 0.01, -2 + 0.02, 3 - 0.03],
                               rtol=1e-5)


def test_sgd_momentum():
    w = np.array([1.0], np.float32)
    mom = 0.0
    for _ in range(3):
        mom = 0.9 * mom - 0.1 * 0.5
        w = w + mom
    wa = nd.array(np.array([1.0], np.float32), ctx=CPU)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    st = opt.create_state(0, wa)
    for _ in range(3):
        opt.update(0, wa, nd.array(np.array([0.5], np.float32), ctx=CPU),
                   st)
    np.testing.assert_allclose(wa.asnumpy(), w, rtol=1e-5)


def test_adam_first_step():
    wa = nd.array(np.array([1.0], np.float32), ctx=CPU)
    opt = mx.optimizer.create("adam", learning_rate=0.1)
    st = opt.create_state(0, wa)
    opt.update(0, wa, nd.array(np.array([0.5], np.float32), ctx=CPU), st)
    m = 0.05
    v = (1 - 0.999) * 0.25
    coef = 0.1 * math.sqrt(1 - 0.999) / (1 - 0.9)
    ref = 1.0 - coef * m / (math.sqrt(v) + 1e-8)
    np.testing.assert_allclose(wa.asnumpy(), [ref], rtol=1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("nag", {"momentum": 0.9}), ("adamw", {}),
])
def test_optimizers_run_and_change_weights(name, kwargs):
    out = _run_opt(name, kwargs)
    assert np.all(np.isfinite(out))
    assert not np.allclose(out, [1.0, -2.0, 3.0])


def test_lr_mult_and_scheduler():
    opt = mx.optimizer.create("sgd", learning_rate=1.0)
    opt.set_lr_mult({0: 0.1})
    assert opt._get_lr(0) == pytest.approx(0.1)
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt2 = mx.optimizer.create("sgd", learning_rate=1.0, lr_scheduler=sched)
    w = nd.array([1.0], ctx=CPU)
    st = opt2.create_state(0, w)
    for _ in range(6):
        opt2.update(0, w, nd.array([0.0], ctx=CPU), st)
    assert sched.base_lr < 1.0


def test_lr_schedulers():
    s = mx.lr_scheduler.MultiFactorScheduler([3, 6], factor=0.1, base_lr=1.0)
    assert s(1) == 1.0
    assert s(4) == pytest.approx(0.1)
    assert s(7) == pytest.approx(0.01)
    c = mx.lr_scheduler.CosineScheduler(10, base_lr=1.0, final_lr=0.0)
    assert c(0) == pytest.approx(1.0)
    assert c(10) == pytest.approx(0.0, abs=1e-6)
    p = mx.lr_scheduler.PolyScheduler(10, base_lr=1.0, pwr=2)
    assert p(0) == pytest.approx(1.0)
    w = mx.lr_scheduler.FactorScheduler(10, 1.0, base_lr=1.0, warmup_steps=5,
                                        warmup_begin_lr=0.0)
    assert w(1) == pytest.approx(0.2)


def test_initializers():
    for init, check in [
        (mx.init.Zero(), lambda a: np.all(a == 0)),
        (mx.init.One(), lambda a: np.all(a == 1)),
        (mx.init.Constant(3.5), lambda a: np.all(a == 3.5)),
        (mx.init.Uniform(0.1), lambda a: np.all(np.abs(a) <= 0.1)),
        (mx.init.Normal(0.01), lambda a: np.abs(a).max() < 0.1),
        (mx.init.Xavier(), lambda a: np.all(np.isfinite(a))),
        (mx.init.MSRAPrelu(), lambda a: np.all(np.isfinite(a))),
        (mx.init.Orthogonal(), lambda a: np.all(np.isfinite(a))),
    ]:
        arr = nd.zeros((8, 8), ctx=CPU)
        init(mx.init.InitDesc("test_weight"), arr)
        assert check(arr.asnumpy()), type(init).__name__


def test_orthogonal_is_orthogonal():
    arr = nd.zeros((6, 6), ctx=CPU)
    mx.init.Orthogonal(scale=1.0)(mx.init.InitDesc("w_weight"), arr)
    a = arr.asnumpy()
    np.testing.assert_allclose(a @ a.T, np.eye(6), atol=1e-4)


def test_init_name_dispatch():
    init = mx.init.Uniform(5.0)
    bias = nd.ones((3,), ctx=CPU)
    init(mx.init.InitDesc("fc_bias"), bias)
    np.testing.assert_allclose(bias.asnumpy(), 0)
    gamma = nd.zeros((3,), ctx=CPU)
    init(mx.init.InitDesc("bn_gamma"), gamma)
    np.testing.assert_allclose(gamma.asnumpy(), 1)


def test_multi_precision():
    w = nd.NDArray(torch.tensor([1.0, 2.0], dtype=torch.float16))
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              multi_precision=True)
    state = opt.create_state_multi_precision(0, w)
    master, _ = state
    assert master.dtype == np.float32
    opt.update_multi_precision(
        0, w, nd.NDArray(torch.tensor([0.5, 0.5], dtype=torch.float16)),
        state)
    assert w.dtype == np.float16
