"""The PyTorch port's autograd against the JAX package's.

The same numpy inputs, made from a seed, are recorded and differentiated by
both packages on the CPU: grad_req "write" overwrites and "add" accumulates
over repeated backwards, "null" takes no gradient; a non-scalar head gets
ones, or the head gradient given; ``pause()`` inside ``record()`` stops
recording; ``mark_variables`` attaches given buffers; ``autograd.grad``
leaves the buffers alone; ``create_graph`` differentiates a gradient.
Gradients agree within rtol 1e-6 (the same few f32 operations).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd

CPU = mx.cpu()
X = np.random.RandomState(0).randn(2, 3).astype(np.float32)
W = np.random.RandomState(1).randn(3, 3).astype(np.float32)


def _run(pkg, req, repeats, head=None, pause=False):
    ctx = {"ctx": CPU} if pkg is mx else {}
    x = pkg.nd.array(X, **ctx)
    w = pkg.nd.array(W, **ctx)
    x.attach_grad(grad_req=req)
    w.attach_grad()
    for _ in range(repeats):
        with pkg.autograd.record():
            h = x * x
            if pause:
                with pkg.autograd.pause():
                    h = h * 3          # not recorded: no gradient through
                    h = h.detach() if pkg is jmx else h
            y = pkg.nd.FullyConnected(h, w, num_hidden=3, no_bias=True)
            out = y * y
        out.backward(None if head is None else pkg.nd.array(head, **ctx))
    return (x.grad.asnumpy() if x.grad is not None else None,
            w.grad.asnumpy())


@pytest.mark.parametrize("req,repeats", [("write", 1), ("write", 3),
                                         ("add", 3), ("null", 2)])
def test_grad_req_matches_jax(req, repeats):
    want, got = _run(jmx, req, repeats), _run(mx, req, repeats)
    if req == "null":
        assert want[0] is None and got[0] is None
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)


def test_head_gradient_and_pause_match_jax():
    head = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    for kw in (dict(head=head), dict(pause=True)):
        want, got = _run(jmx, "write", 1, **kw), _run(mx, "write", 1, **kw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_nothing_is_recorded_outside_record():
    x = nd.array(X, ctx=CPU)
    x.attach_grad()
    y = x * 2
    assert y._t.grad_fn is None and not y._t.requires_grad
    with autograd.record():
        z = x * 2
        with autograd.pause():
            assert not autograd.is_recording()
            u = z * 2
    assert z._t.grad_fn is not None and u._t.grad_fn is None
    assert not autograd.is_training() and not autograd.is_recording()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    with autograd.predict_mode():
        assert not autograd.is_training()
    old = autograd.set_training(True)
    assert autograd.is_training() and not old
    autograd.set_training(old)
    assert autograd.set_recording(False) is False


def test_mark_variables_and_grad_match_jax():
    out = {}
    for pkg in (jmx, mx):
        ctx = {"ctx": CPU} if pkg is mx else {}
        x = pkg.nd.array(X, **ctx)
        g = pkg.nd.zeros(X.shape, **ctx)
        pkg.autograd.mark_variables([x], [g])
        with pkg.autograd.record():
            y = (x * x * x).sum()
        y.backward()
        assert x.grad is g
        x2 = pkg.nd.array(X, **ctx)
        x2.attach_grad()
        with pkg.autograd.record():
            z = (x2 * x2).sum()
        gz = pkg.autograd.grad(z, [x2])[0]
        assert np.all(x2.grad.asnumpy() == 0)
        out[pkg] = (g.asnumpy(), gz.asnumpy())
    for a, b in zip(out[mx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_create_graph_matches_jax():
    out = {}
    for pkg in (jmx, mx):
        ctx = {"ctx": CPU} if pkg is mx else {}
        x = pkg.nd.array(X, **ctx)
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
            g = pkg.autograd.grad(y, [x], create_graph=True)[0]
            z = (g * g).sum()
        z.backward()
        out[pkg] = x.grad.asnumpy()
    np.testing.assert_allclose(out[mx], out[jmx], rtol=1e-6)


def test_function_is_not_ported_and_says_so():
    class Twice(autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 2
    with pytest.raises(NotImplementedError, match="item 4"):
        Twice()(nd.ones((2,), ctx=CPU))


def test_second_backward_without_retain_graph_fails_loudly():
    x = nd.array([2.0], ctx=CPU)
    x.attach_grad()
    with autograd.record():
        y = x * x * x
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    assert torch.equal(x.grad._t, torch.tensor([12.0]))
