"""The PyTorch port's ResNet (gluon layers, model zoo, conv-net ops)
against the JAX package's.

JAX-built weights (drawn from numpy's global RNG) are carried to the port by
name with ``params_from_jax``:
- ``resnet18_v1`` and ``resnet50_v2`` in inference mode against the
  committed logit goldens, built exactly as
  tests/test_reference_interchange.py builds them (rtol 1e-4, atol 1e-5);
- a small bottleneck ``_ResNet`` (v1 and v2) in training mode: logits, every
  gradient and the moved running statistics within rtol 1e-5 and an atol of
  1e-6 or 1e-5 of the tensor's largest magnitude, whichever is larger. The
  second term is the fp32 floor of the computation itself: against the same
  net run in float64, the port's logits (magnitude ~1.3) are off by
  1.5e-6 and the JAX package's by 1.4e-6, and the stem conv's weight
  gradient of each by ~3e-6, so an absolute 1e-6 between the two is
  tighter than either package's own error;
- the names of ``resnet50_v1`` (299) equal the JAX net's;
- max pooling over windows of tied zeros, as after the stem's ReLU, routes
  the gradient where JAX's does (each window's first maximum).
The JAX stem runs its space-to-depth form of the 7x7/2 conv
(``MXTPU_CONV1_S2D``), the port the plain conv: the same sums in another
order, inside the tolerances.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd, nd
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    _ResNet, params_from_jax)
from incubator_mxnet_tpu_torch.ops import nn as tops

DATA = pathlib.Path(__file__).resolve().parent / "data"
SMALL = dict(kind="bottleneck", layers=[1, 2], channels=[8, 16, 32],
             classes=10)


def _jax_params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v2"])
def test_zoo_logits_match_the_committed_golden(name):
    fname = ("resnet18_logit_golden.npz" if name == "resnet18_v1"
             else "zoo_logit_golden_%s.npz" % name)
    np.random.seed(1234)
    jnet = mx.gluon.model_zoo.vision.get_model(name)
    jnet.initialize(mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    x = np.random.RandomState(7).rand(2, 3, 64, 64).astype(np.float32)
    jnet(nd.array(x))                   # materializes the deferred shapes
    net = params_from_jax(_jax_params(jnet),
                          vision.get_model(name, device="cpu"))
    assert not tautograd.is_training()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.load(DATA / fname)["logits"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_resnet50_v1_names_and_sizes_match_jax():
    jnames = set(jresnet.resnet50_v1()._collect_params_with_prefix())
    net = vision.resnet50_v1(device="cpu")
    names = [k for k, _ in net.named_parameters()] \
        + [k for k, _ in net.named_buffers()]
    assert len(names) == len(jnames) == 299 and set(names) == jnames
    assert names[:2] == ["features.0.weight", "features.1.gamma"]
    assert "output.bias" in names
    trained = [p for p in net.parameters() if p.requires_grad]
    assert len(trained) == 193
    assert sum(p.numel() for p in trained) == 25575912


def _small_jax(preact, seed=0):
    np.random.seed(seed)
    jnet = jresnet._ResNet(SMALL["kind"], SMALL["layers"], SMALL["channels"],
                           preact=preact, classes=SMALL["classes"])
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    return jnet


def _small_port(params, preact):
    net = _ResNet(SMALL["kind"], SMALL["layers"], SMALL["channels"],
                  preact=preact, classes=SMALL["classes"], device="cpu")
    return params_from_jax(params, net)


def _batch(seed=1, B=4, size=32):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, 3, size, size).astype(np.float32),
            rs.randint(0, SMALL["classes"], (B,)).astype(np.float32))


def _loss(out, lab):
    logp = torch.log_softmax(out.float(), dim=-1)
    return -logp.gather(-1, lab.long()[:, None]).mean()


def _close(got, want, what):
    """rtol 1e-5; atol 1e-6 or 1e-5 of the tensor's largest magnitude (the
    module docstring says why)."""
    atol = max(1e-6, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


@pytest.mark.parametrize("preact", [False, True], ids=["v1", "v2"])
def test_small_resnet_training_forward_and_gradients_match_jax(preact):
    jnet = _small_jax(preact)
    params = _jax_params(jnet)
    net = _small_port(params, preact)
    x, y = _batch()
    with autograd.record():
        jout = jnet(nd.array(x))
        jl = -nd.pick(nd.log_softmax(jout, axis=-1), nd.array(y),
                      axis=-1).mean()
    jl.backward()
    jgrads = {k: p.grad().asnumpy() for k, p in
              jnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    jafter = _jax_params(jnet)

    with tautograd.train_mode():
        out = net(torch.from_numpy(x))
    loss = _loss(out, torch.from_numpy(y))
    loss.backward()
    _close(out.detach().numpy(), jout.asnumpy(), "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl.asnumpy()),
                               rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()
             if p.requires_grad}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        _close(g, jgrads[k], k)
    moved = 0
    for k, v in net.named_buffers():
        _close(v.numpy(), jafter[k], k)
        moved += not np.array_equal(jafter[k], params[k])
    assert moved == len(list(net.named_buffers()))
    if preact:
        # the input BN (scale and center off) takes no gradient
        gamma = dict(net.named_parameters())["features.0.gamma"]
        assert not gamma.requires_grad and gamma.grad is None


def test_max_pool_gradient_on_ties_matches_jax():
    """3x3/2 pad-1 max pooling, as after the stem's ReLU, over windows that
    hold only zeros and windows with a tied positive maximum."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randn(2, 3, 17, 17), 0).astype(np.float32)
    x[:, :, 4:9, 4:9] = 0.0
    x[0, 1, 10:13, 10:13] = 0.5
    dy = rs.randn(2, 3, 9, 9).astype(np.float32)
    kw = dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1))

    def f(a):
        return (jnn.pooling(a, **kw) * dy).sum()
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tops.pooling(xt, **kw).backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(2, 2), pool_type="sum", stride=(1, 1)),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True),
    dict(kernel=(1, 1), pool_type="max", global_pool=True),
    dict(kernel=(3,), pool_type="sum", stride=(2,), pad=(1,)),
], ids=["avg", "avg_exclude_pad", "sum", "global_avg", "global_max",
        "sum_1d"])
def test_pooling_matches_jax(kw):
    shape = (2, 3, 9) if len(kw["kernel"]) == 1 else (2, 3, 9, 7)
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = np.asarray(jnn.pooling(jnp.asarray(x), **kw))
    got = tops.pooling(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_convolution_matches_jax_grouped_strided_dilated():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 11, 9).astype(np.float32)
    w = rs.randn(6, 2, 3, 3).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
              num_filter=6, num_group=2)
    want = np.asarray(jnn.convolution(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), **kw))
    got = tops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("training", [False, True], ids=["infer", "train"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_op_matches_jax(training, fix_gamma):
    rs = np.random.RandomState(6)
    x = (rs.randn(4, 3, 5, 5) * 2 + 1).astype(np.float32)
    g, b = (rs.rand(3) + 0.5).astype(np.float32), rs.randn(3).astype(
        np.float32)
    mm, mv = rs.randn(3).astype(np.float32), (rs.rand(3) + 0.5).astype(
        np.float32)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, training=training)
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, mm, mv)), **kw)
    got = tops.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, mm, mv)),
                          **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_params_from_jax_checks_names_and_shapes_both_ways():
    params = _jax_params(_small_jax(False))
    net = _small_port(params, False)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({k: v for k, v in params.items()
                         if k != "output.bias"}, net)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(dict(params, **{"output.gamma": np.ones(1)}), net)
    bad = dict(params)
    bad["output.weight"] = bad["output.weight"][:, :-1]
    with pytest.raises(ValueError, match="output.weight"):
        params_from_jax(bad, net)


@pytest.fixture
def gluon_names_unchanged():
    """Gluon names blocks from per-alias counters global to the process
    (``_BlockScope``); a test that builds the port's nets and no JAX ones
    restores them, so that a later test in the same process that compares
    the two packages' names sees both counters where it would."""
    from incubator_mxnet_tpu_torch.gluon.block import _BlockScope
    saved = dict(_BlockScope._counters)
    yield
    _BlockScope._counters.clear()
    _BlockScope._counters.update(saved)


def test_what_this_slice_does_not_carry_raises(monkeypatch,
                                              gluon_names_unchanged):
    with pytest.raises(NotImplementedError, match="item 9"):
        vision.resnet50_v1(device="cpu", remat_stages={"stage1"})
    monkeypatch.setenv("MXTPU_RESNET_REMAT", "stage1")
    with pytest.raises(NotImplementedError, match="item 9"):
        vision.resnet18_v1(device="cpu")
    monkeypatch.delenv("MXTPU_RESNET_REMAT")
    with pytest.raises(NotImplementedError, match="item 5"):
        tnn.MaxPool2D(2, ceil_mode=True)(torch.zeros(1, 1, 4, 4))
    with pytest.raises(NotImplementedError, match="item 5"):
        tops.pooling(torch.zeros(1, 1, 4, 4), kernel=(2, 2), pool_type="lp")
    with pytest.raises(NotImplementedError, match="item 10"):
        vision.get_model("densenet121", device="cpu")
    with pytest.raises(RuntimeError, match="pretrained"):
        vision.resnet18_v1(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("lenet", device="cpu")
