"""The PyTorch port's gluon core against the JAX package's: Parameter,
Block / HybridBlock, initializers, save / load and losses.

The same numpy inputs and numpy-seeded draws go through both packages on the
CPU. Initializers draw from numpy's global RNG in the JAX package's order,
so ``np.random.seed(s); net.initialize(init)`` and the first forward give
the JAX net's weights bitwise (every initializer, a small ResNet v1 and
``resnet18_v1``). Parameter files cross the packages both ways. Losses and
their input gradients agree within rtol 1e-6 / atol 1e-7 (log-softmax sums
in another order). ``hybridize()`` runs eagerly in the port and gives the
eager numbers exactly.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

CPU = mx.cpu()
SMALL = dict(kind="bottleneck", layers=[1, 2], channels=[8, 16, 32],
             preact=False, classes=10)


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name,kw", [
    ("Uniform", {}), ("Uniform", {"scale": 0.3}), ("Normal", {}),
    ("Normal", {"sigma": 2.0}), ("Constant", {"value": 0.25}), ("One", {}),
    ("Zero", {}), ("Orthogonal", {}), ("Orthogonal", {"rand_type": "normal"}),
    ("Xavier", {}), ("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                                "magnitude": 2}),
    ("MSRAPrelu", {})])
def test_initializers_draw_the_jax_packages_values_bitwise(name, kw):
    shape = (6, 4, 3, 3)
    out = []
    for pkg, arr in ((jmx, jmx.nd.zeros(shape)),
                     (mx, nd.zeros(shape, ctx=CPU))):
        np.random.seed(7)
        getattr(pkg.init, name)(**kw)(pkg.init.InitDesc("conv_weight"), arr)
        out.append(arr.asnumpy())
    np.testing.assert_array_equal(out[1], out[0])
    for role, fill in (("fc_bias", 0.0), ("bn_gamma", 1.0),
                       ("bn_running_var", 1.0)):
        b = nd.full((3,), 5.0, ctx=CPU)
        mx.init.Xavier()(mx.init.InitDesc(role), b)
        assert np.all(b.asnumpy() == fill)


@pytest.mark.parametrize("build", ["small", "resnet18_v1"])
def test_initialize_gives_the_jax_nets_weights_bitwise(build):
    def make(pkg_res):
        if build == "small":
            return pkg_res._ResNet(**SMALL)
        return pkg_res.resnet18_v1(classes=10, thumbnail=True)
    def known(net):
        return {k for k, p in net._collect_params_with_prefix().items()
                if p._data is not None}
    np.random.seed(11)
    jnet = make(jres)
    jnet.initialize(jmx.init.Xavier())
    jknown = known(jnet)
    jnet(jmx.nd.zeros((1, 3, 32, 32)))
    np.random.seed(11)
    net = make(tres)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    # the same layers are given their in_channels, so the same parameters
    # draw at initialize() and the rest at the first forward
    assert known(net) == jknown
    assert {k for k, _ in net.named_parameters()} <= jknown
    net(nd.zeros((1, 3, 32, 32), ctx=CPU))
    want, got = _params(jnet), _params(net)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    names = [k for k, _ in net.named_parameters()] \
        + [k for k, _ in net.named_buffers()]
    assert sorted(names) == sorted(want)
    assert [p.name for p in net.collect_params().values()] == \
        [p.name for p in jnet.collect_params().values()]


def test_parameter_deferred_init_grad_req_and_lr_mult():
    p = gluon.Parameter("w", shape=(5, 0), allow_deferred_init=True,
                        lr_mult=0.5, wd_mult=0.0)
    p.initialize(ctx=CPU)
    with pytest.raises(gluon.DeferredInitializationError):
        p.data()
    p.shape_inferred((5, 7))
    assert p.data().shape == (5, 7) and p.grad().shape == (5, 7)
    assert isinstance(p.data()._t, torch.nn.Parameter)
    assert p.data()._t.requires_grad
    p.grad_req = "null"
    assert p.data()._grad is None and not p.data()._t.requires_grad
    with pytest.raises(RuntimeError, match="no gradient"):
        p.grad()
    p.grad_req = "add"
    assert p.grad().shape == (5, 7)
    with pytest.raises(ValueError, match="deferred init is not allowed"):
        gluon.Parameter("v", shape=(0, 3)).initialize(ctx=CPU)
    with pytest.raises(ValueError, match="incompatible"):
        p.shape_inferred((4, 7))
    c = gluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=CPU)
    np.testing.assert_array_equal(c.data().asnumpy(), [0, 1, 2])
    assert c.grad_req == "null"


def test_blocks_are_torch_modules_named_as_gluon():
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4),
                nn.Dense(2))
    net.initialize(mx.init.One(), ctx=CPU)
    # the last Dense's weight waits for its input; its bias does not
    assert [k for k, _ in net.named_parameters()] == [
        "0.weight", "0.bias", "1.gamma", "1.beta", "2.bias"]
    assert [k for k, _ in net.named_buffers()] == ["1.running_mean",
                                                   "1.running_var"]
    net(nd.ones((2, 3), ctx=CPU))
    assert "2.weight" in dict(net.named_parameters())
    assert list(net.collect_params(".*weight").keys()) == [
        "net_dense0_weight", "net_dense1_weight"]
    assert len(net.collect_params()) == 8
    assert isinstance(net[0], nn.Dense) and len(net) == 3
    # .double() swaps the tensors; the Parameters follow them
    net.double()
    assert net[0].weight.data()._t is dict(net.named_parameters())[
        "0.weight"]
    assert net[0].weight.data().dtype == np.float64
    assert net[1].running_mean.data()._t is dict(net.named_buffers())[
        "1.running_mean"]
    assert net[0].weight.grad().dtype == np.float64


def test_shared_params_hooks_and_summary(capsys):
    d1 = nn.Dense(4, in_units=4)
    d2 = nn.Dense(4, in_units=4, params=d1.params)
    d1.initialize(ctx=CPU)
    x = nd.array(np.random.RandomState(0).rand(2, 4), ctx=CPU)
    np.testing.assert_array_equal(d1(x).asnumpy(), d2(x).asnumpy())
    assert d2.weight is d1.weight
    assert dict(d2.named_parameters())["weight"] is d1.weight.data()._t
    seen = []
    h = d1.register_forward_hook(lambda b, a, o: seen.append(o.shape))
    d1.register_forward_pre_hook(lambda b, a: seen.append("pre"))
    d1(x)
    h.detach()
    d1(x)
    assert seen == ["pre", (2, 4), "pre"]
    d1.summary(x)
    assert "Total params: 20" in capsys.readouterr().out


def test_save_load_parameters_cross_the_packages(tmp_path):
    np.random.seed(3)
    jnet = jres._ResNet(**SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((1, 3, 32, 32)))
    f = str(tmp_path / "j.params")
    jnet.save_parameters(f)
    net = tres._ResNet(**SMALL)
    net.load_parameters(f, ctx=CPU)
    want = _params(jnet)
    got = _params(net)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    x = np.random.RandomState(5).rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(net(nd.array(x, ctx=CPU)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)
    for p in net.collect_params().values():
        p.set_data(p.data() * 2)
    g = str(tmp_path / "t.params")
    net.save_parameters(g)
    jnet.load_parameters(g)
    for k, v in _params(jnet).items():
        np.testing.assert_array_equal(v, 2 * want[k])
    h = str(tmp_path / "pd.params")
    net.collect_params().save(h, strip_prefix=net.prefix)
    other = tres._ResNet(**SMALL)
    other.collect_params().load(h, ctx=CPU, restore_prefix=other.prefix)
    for k, v in _params(other).items():
        np.testing.assert_array_equal(v, 2 * want[k])
    with pytest.raises(IOError, match="missing"):
        nn.Dense(3).load_parameters(g)


@pytest.mark.parametrize("loss,kw", [
    ("SoftmaxCrossEntropyLoss", {}),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "weight": 0.5}),
    ("L2Loss", {}), ("L1Loss", {"weight": 2.0})])
def test_losses_and_their_gradients_match_jax(loss, kw):
    rs = np.random.RandomState(9)
    pred = rs.randn(4, 5).astype(np.float32)
    if loss.startswith("Softmax") and kw.get("sparse_label", True):
        label = np.array([0, 4, 2.0, 3], np.float32)
    else:
        label = rs.rand(4, 5).astype(np.float32)
    sw = rs.rand(4, 1).astype(np.float32)
    out = {}
    for pkg in (jmx, mx):
        ctx = {"ctx": CPU} if pkg is mx else {}
        p = pkg.nd.array(pred, **ctx)
        p.attach_grad()
        fn = getattr(pkg.gluon.loss, loss)(**kw)
        with pkg.autograd.record():
            val = fn(p, pkg.nd.array(label, **ctx),
                     pkg.nd.array(sw, **ctx))
        val.backward()
        out[pkg] = (val.asnumpy(), p.grad.asnumpy())
    for a, b in zip(out[mx], out[jmx]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_hybridize_gives_the_eager_numbers():
    np.random.seed(4)
    net = tres._ResNet(**SMALL)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = nd.array(np.random.RandomState(6).rand(2, 3, 32, 32), ctx=CPU)
    eager = net(x).asnumpy()
    net.hybridize()
    assert net._active and net.features._active
    np.testing.assert_array_equal(net(x).asnumpy(), eager)
    with autograd.record():
        a = net(x)
    net.hybridize(False)
    with autograd.record():
        b = net(x)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
