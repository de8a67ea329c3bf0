"""The eager gluon training loop of the PyTorch port against the JAX
package's: ``autograd.record()`` -> ``loss.backward()`` ->
``gluon.Trainer.step``.

The same numpy-seeded weights (``np.random.seed``; ``initialize``) and
batches go through both packages on the CPU, where the port's fused seam
takes its plain per-tensor rules and the JAX package's its lax fallback.
- A small MLP (as ``tests/test_fused_optim.py`` builds it) and a small
  bottleneck ResNet v1, 3 steps of sgd (momentum; momentum with wd and a
  gradient clip), nag, adam and adamw: losses within rtol 1e-5 and every
  parameter within rtol 1e-4 / atol 1e-6, the tolerance of the trainers'
  port-vs-JAX tests. On the ResNet, Adam and AdamW hold every tensor within
  2 * lr * steps instead, the card-vs-CPU rule for AdamW: a v1 conv bias
  feeds a BatchNorm, so its exact gradient is 0 and both sides hold
  roundoff there, which Adam normalizes into steps of up to lr either way;
  those biases move the running means, and Adam does the same to every
  element whose gradient is small (up to 4e-2 of a tensor's max apart
  after 3 steps at lr 0.01).
- ``resnet18_v1`` (thumbnail, B = 4 x 32 x 32): its gradients are not
  determined to 1e-4 by its fp32 inputs (ReLU gates within roundoff of 0;
  against the same net in float64 the port's step-1 gradients sit up to
  3.8 % of a tensor's max away, the JAX package's up to 1.9 %, in other
  tensors), so free-running steps part at step 2. Each of 3 steps starts
  the port from the JAX trainer's state (parameters, running statistics,
  and optimizer state through ``save_states`` / ``load_states``; the JAX
  net hybridized, to keep the test short): the step's loss (the batch
  mean) within rtol 1e-5 and the moved running statistics within 1e-5 of
  their largest magnitude.
- Inside the port, the fused path equals ``MXTPU_FUSED_OPTIM=0``'s
  per-parameter rules bitwise; a step puts each (lr, wd) group through one
  call of the seam (two with ``wd_mult = 0`` on the biases).
"""

import functools
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

CPU = mx.cpu()
OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "sgd_wd_clip": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-3, "clip_gradient": 0.05}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    "adamw": ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
}
SMALL = dict(kind="bottleneck", layers=[1, 2], channels=[8, 16, 32],
             preact=False, classes=10)
STEPS = 3


def _ctx(pkg):
    return {"ctx": CPU} if pkg is mx else {}


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
                pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _init(pkg, build, seed, sample):
    np.random.seed(seed)
    net = build(pkg)
    net.initialize(pkg.init.Xavier(), **_ctx(pkg))
    net(pkg.nd.array(sample, **_ctx(pkg)))
    return net


def _batch(kind, seed=1):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        return (rs.rand(16, 8).astype(np.float32),
                rs.randint(0, 4, (16,)).astype(np.float32))
    return (rs.rand(4, 3, 32, 32).astype(np.float32),
            rs.randint(0, 10, (4,)).astype(np.float32))


def _builder(kind):
    if kind == "mlp":
        return _mlp
    return lambda pkg: (jres if pkg is jmx else tres)._ResNet(**SMALL)


def _train(pkg, kind, opt, hp, steps=STEPS, wd_mult_bias=None):
    x, y = _batch(kind)
    net = _init(pkg, _builder(kind), 0, x[:1])
    params = net.collect_params()
    if wd_mult_bias is not None:
        for p in params.values():
            if p.name.endswith("bias"):
                p.wd_mult = wd_mult_bias
    tr = pkg.gluon.Trainer(params, opt, dict(hp))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, **_ctx(pkg))),
                           pkg.nd.array(y, **_ctx(pkg)))
        loss.backward()
        tr.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, {k: p.data().asnumpy() for k, p in
                    net._collect_params_with_prefix().items()}, tr


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_eager_loop_matches_jax(kind, name):
    opt, hp = OPTS[name]
    jl, jp, _ = _train(jmx, kind, opt, hp)
    tl, tp, _ = _train(mx, kind, opt, hp)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert list(tp) == list(jp)
    tol = dict(rtol=1e-4, atol=1e-6)
    if kind == "resnet" and opt.startswith("adam"):
        tol = dict(rtol=0, atol=2 * hp["learning_rate"] * STEPS)
    for k, want in jp.items():
        np.testing.assert_allclose(tp[k], want, err_msg=k, **tol)


@pytest.mark.parametrize("name", ["sgd_wd_clip", "adam", "adamw"])
def test_fused_equals_per_parameter_bitwise(name, monkeypatch):
    opt, hp = OPTS[name]
    runs = []
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_OPTIM", fused)
        losses, params, tr = _train(mx, "resnet", opt, hp)
        runs.append((losses, params, tr._updaters[0].fused_launches))
    (l1, p1, n1), (l0, p0, n0) = runs
    assert l1 == l0
    for k in p1:
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
    assert (n1, n0) == (STEPS, 0)


@pytest.mark.parametrize("wd_mult,groups", [(None, 1), (0.0, 2)])
def test_a_step_launches_once_per_group(wd_mult, groups):
    """SGD groups by (lr, wd): wd_mult 0 on the biases makes two groups."""
    opt, hp = OPTS["sgd_wd_clip"]
    _, _, tr = _train(mx, "mlp", opt, hp, steps=2, wd_mult_bias=wd_mult)
    assert tr._updaters[0].fused_launches == 2 * groups


def test_momentum_zero_and_nag_stay_per_parameter():
    for opt, hp in (("sgd", {"learning_rate": 0.1}), OPTS["nag"]):
        _, _, tr = _train(mx, "mlp", opt, hp, steps=1)
        assert tr._updaters[0].fused_launches == 0


def test_step_two_sees_step_ones_update_in_place():
    """The update lands in the tensors the module reads: after a step the
    Parameter's data, the module's registered tensor and the forward
    agree."""
    x, y = _batch("mlp")
    net = _init(mx, _mlp, 0, x[:1])
    w = net[0].weight
    t = w.data()._t
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5, "momentum": 0.9})
    before = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x, ctx=CPU)), mx.nd.array(y, ctx=CPU))
    loss.backward()
    tr.step(16)
    assert w.data()._t is t is dict(net.named_parameters())["0.weight"]
    after = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert not np.allclose(before, after)
    with torch.no_grad():
        ref = torch.relu(torch.from_numpy(x) @ t.t() + net[0].bias.data()._t)
        ref = ref @ net[1].weight.data()._t.t() + net[1].bias.data()._t
    np.testing.assert_allclose(after, ref.numpy(), rtol=1e-6, atol=1e-6)


def test_save_load_states_cross_the_packages(tmp_path):
    opt, hp = OPTS["adam"]
    _, _, jtr = _train(jmx, "mlp", opt, hp, steps=2)
    _, _, ttr = _train(mx, "mlp", opt, hp, steps=2)
    jf, tf = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(jf)
    ttr.save_states(tf)
    ttr.load_states(jf)
    jtr.load_states(tf)
    js, ts = jtr._updaters[0].states, ttr._updaters[0].states
    assert sorted(js) == sorted(ts) and len(ts) == 4
    for i in js:
        for a, b in zip(js[i], ts[i]):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=1e-5,
                                       atol=1e-7)


@functools.lru_cache(maxsize=None)
def _resnet18_pair():
    """The batch, the JAX net (hybridized: one compile for every test) and
    the port's net from the same numpy seed, and their starting values."""
    rs = np.random.RandomState(2)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)

    def build(pkg):
        return (jres if pkg is jmx else tres).resnet18_v1(classes=10,
                                                          thumbnail=True)
    jnet, tnet = (_init(pkg, build, 5, x[:1]) for pkg in (jmx, mx))
    jnet.hybridize()
    start = {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()}
    return x, y, jnet, tnet, start


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_resnet18_steps_from_the_jax_state_match(name, tmp_path):
    opt, hp = OPTS[name]
    x, y, jnet, tnet, start = _resnet18_pair()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(start[k])
    jtr, ttr = (pkg.gluon.Trainer(n.collect_params(), opt, dict(hp))
                for pkg, n in ((jmx, jnet), (mx, tnet)))
    jparams = jnet._collect_params_with_prefix()
    tparams = tnet._collect_params_with_prefix()
    states = str(tmp_path / "states")
    for step in range(STEPS):
        for k, p in jparams.items():
            tparams[k].set_data(p.data().asnumpy())
        if step:
            jtr.save_states(states)
            ttr.load_states(states)
            ttr._optimizer._index_update_count = dict(
                jtr._optimizer._index_update_count)
            ttr._optimizer.num_update = jtr._optimizer.num_update
        losses = []
        for pkg, net, tr in ((jmx, jnet, jtr), (mx, tnet, ttr)):
            with pkg.autograd.record():
                loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
                    net(pkg.nd.array(x, **_ctx(pkg))),
                    pkg.nd.array(y, **_ctx(pkg)))
            loss.backward()
            tr.step(4)
            losses.append(loss.asnumpy())
        what = "step %d" % (step + 1)
        np.testing.assert_allclose(losses[1].mean(), losses[0].mean(),
                                   rtol=1e-5, err_msg=what)
        for k, p in jparams.items():
            if ".running_" in k:
                want = p.data().asnumpy()
                np.testing.assert_allclose(
                    tparams[k].data().asnumpy(), want, rtol=0,
                    atol=1e-5 * float(np.abs(want).max()), err_msg=k)
    assert os.path.getsize(states) > 0
