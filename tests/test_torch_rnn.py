"""The PyTorch port's fused RNN (``ops/rnn.py``) and gluon recurrent layers
against the JAX package's, on the CPU.

The same numpy inputs and weights, made from a seed, go through both
packages: ``rnn_forward`` and the packed ``RNN`` op for lstm, gru, rnn_relu
and rnn_tanh, 1-2 layers, uni- and bidirectional; the gluon ``LSTM`` / ``GRU``
/ ``RNN`` layers in both layouts, with and without states, forward and
gradients under ``autograd.record()``. Tolerance rtol = atol = 1e-5 (fp32,
matmuls summed in another order). ``gluon.rnn.LSTM(64, 2)``, initialized as
the reference's interchange test initializes it (numpy's global RNG), is
held to the committed golden ``flagship_golden_lstm_wordlm_trunk.npz`` at the
golden's own rtol 1e-4 / atol 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.ops import rnn as jops
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.gluon import rnn
from incubator_mxnet_tpu_torch.ops import rnn as tops
from incubator_mxnet_tpu_torch.ops.registry import get_op

RTOL = ATOL = 1e-5
MODES = ["lstm", "gru", "rnn_relu", "rnn_tanh"]
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "flagship_golden_lstm_wordlm_trunk.npz")
CPU = mx.cpu()


def _case(mode, layers, bidirectional, T=5, N=3, C=6, H=4, seed=0):
    rs = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    size = jops.rnn_param_size(C, H, layers, mode, bidirectional)
    flat = (rs.randn(size) * 0.4).astype(np.float32)
    x = rs.randn(T, N, C).astype(np.float32)
    h0 = (rs.randn(layers * dirs, N, H) * 0.5).astype(np.float32)
    c0 = (rs.randn(layers * dirs, N, H) * 0.5).astype(np.float32)
    return flat, x, h0, c0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
def test_rnn_forward_matches_jax(mode, layers, bidirectional):
    C, H = 6, 4
    flat, x, h0, c0 = _case(mode, layers, bidirectional, C=C, H=H)
    assert tops.rnn_param_size(C, H, layers, mode, bidirectional) \
        == flat.size
    assert tops.rnn_param_slices(C, H, layers, mode, bidirectional) \
        == jops.rnn_param_slices(C, H, layers, mode, bidirectional)
    jl = jops.unpack_rnn_params(jnp.asarray(flat), C, H, layers, mode,
                                bidirectional)
    tl = tops.unpack_rnn_params(torch.from_numpy(flat), C, H, layers, mode,
                                bidirectional)
    c_init = (lambda a: a) if mode == "lstm" else (lambda a: None)
    jout = jops.rnn_forward(jnp.asarray(x), jl, jnp.asarray(h0),
                            c_init(jnp.asarray(c0)), mode, bidirectional)
    tout = tops.rnn_forward(torch.from_numpy(x), tl, torch.from_numpy(h0),
                            c_init(torch.from_numpy(c0)), mode,
                            bidirectional)
    for j, t in zip(jout, tout):
        if j is None:
            assert t is None
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state_outputs", [True, False])
def test_packed_rnn_op_matches_jax(mode, state_outputs):
    C, H, L = 6, 4, 2
    flat, x, h0, c0 = _case(mode, L, True, C=C, H=H, seed=1)
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=True,
              state_outputs=state_outputs)
    jcell = jnp.asarray(c0) if mode == "lstm" else None
    tcell = torch.from_numpy(c0) if mode == "lstm" else None
    jres = jops.rnn(jnp.asarray(x), jnp.asarray(flat), jnp.asarray(h0),
                    jcell, **kw)
    tres = get_op("RNN")(torch.from_numpy(x), torch.from_numpy(flat),
                         torch.from_numpy(h0), tcell, **kw)
    if not state_outputs:
        jres, tres = (jres,), (tres,)
    assert len(tres) == len(jres) == jops._rnn_num_outputs(
        dict(mode=mode, state_outputs=state_outputs))
    assert tops._rnn_num_outputs(dict(mode=mode,
                                      state_outputs=str(state_outputs))) \
        == len(jres)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def test_training_dropout_between_layers_waits_for_the_dropout_op():
    flat, x, h0, c0 = _case("lstm", 2, False)
    tl = tops.unpack_rnn_params(torch.from_numpy(flat), 6, 4, 2, "lstm")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tops.rnn_forward(torch.from_numpy(x), tl, torch.from_numpy(h0),
                         torch.from_numpy(c0), p=0.5, training=True)
    # outside training p does nothing, as in the reference
    tops.rnn_forward(torch.from_numpy(x), tl, torch.from_numpy(h0),
                     torch.from_numpy(c0), p=0.5, training=False)


_LAYERS = {"lstm": (jrnn.LSTM, rnn.LSTM), "gru": (jrnn.GRU, rnn.GRU),
           "rnn_tanh": (jrnn.RNN, rnn.RNN)}


def _layer_pair(mode, layout, bidirectional, H=5, L=2):
    jcls, tcls = _LAYERS[mode]
    kw = dict(layout=layout, bidirectional=bidirectional)
    if mode == "rnn_tanh":
        kw["activation"] = "tanh"
    np.random.seed(5)
    jl = jcls(H, L, **kw)
    jl.initialize(jmx.init.Xavier())
    tl = tcls(H, L, **kw)
    tl.initialize(mx.init.Xavier(), ctx=CPU)
    return jl, tl


def _carry_weights(jl, tl, sample_j, sample_t):
    jl(sample_j)                    # finish the deferred i2h shapes
    tl(sample_t)
    jp = jl._collect_params_with_prefix()
    tp = tl._collect_params_with_prefix()
    assert sorted(jp) == sorted(tp)
    for k, p in tp.items():
        p.set_data(jp[k].data().asnumpy())


@pytest.mark.parametrize("mode", sorted(_LAYERS))
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_gluon_layers_match_jax_forward_and_gradients(mode, layout,
                                                      bidirectional):
    T, N, C = 4, 3, 7
    rs = np.random.RandomState(2)
    x = rs.randn(*((T, N, C) if layout == "TNC" else (N, T, C))) \
        .astype(np.float32)
    jl, tl = _layer_pair(mode, layout, bidirectional)
    _carry_weights(jl, tl, jmx.nd.array(x), nd.array(x, ctx=CPU))

    # without states: the output alone
    np.testing.assert_allclose(tl(nd.array(x, ctx=CPU)).asnumpy(),
                               jl(jmx.nd.array(x)).asnumpy(),
                               rtol=RTOL, atol=ATOL)

    # with states (a list): (output, new states), and the gradients
    jst = jl.begin_state(N)
    tst = tl.begin_state(N)
    assert [s.shape for s in tst] == [s.shape for s in jst]
    h = (rs.randn(*jst[0].shape) * 0.5).astype(np.float32)
    jst = [jmx.nd.array(h) for _ in jst]
    tst = [nd.array(h, ctx=CPU) for _ in tst]
    jx, tx = jmx.nd.array(x), nd.array(x, ctx=CPU)
    jx.attach_grad()
    tx.attach_grad()
    with jautograd.record():
        jout, jnew = jl(jx, jst)
        jloss = (jout * jout).sum() + sum((s * s).sum() for s in jnew)
    jloss.backward()
    with autograd.record():
        tout, tnew = tl(tx, tst)
        tloss = (tout * tout).sum() + sum((s * s).sum() for s in tnew)
    tloss.backward()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=RTOL, atol=ATOL)
    jp = jl._collect_params_with_prefix()
    for k, p in tl._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.grad().asnumpy(),
                                   jp[k].grad().asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_gluon_layer_takes_states_as_separate_arguments_and_tensors():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 2, 5).astype(np.float32)
    jl, tl = _layer_pair("lstm", "TNC", False, H=4, L=1)
    _carry_weights(jl, tl, jmx.nd.array(x), nd.array(x, ctx=CPU))
    h = np.zeros((1, 2, 4), np.float32)
    c = (rs.randn(1, 2, 4) * 0.3).astype(np.float32)
    jout, jst = jl(jmx.nd.array(x), jmx.nd.array(h), jmx.nd.array(c))
    tout, tst = tl(nd.array(x, ctx=CPU), nd.array(h, ctx=CPU),
                   nd.array(c, ctx=CPU))
    assert isinstance(tst, tuple) and len(tst) == 2
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    # tensors in, tensors out: the serving path
    with torch.inference_mode():
        out, st = tl(torch.from_numpy(x), [torch.from_numpy(h),
                                            torch.from_numpy(c)])
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), jout.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st[1].numpy(), jst[1].asnumpy(), rtol=RTOL,
                               atol=ATOL)


def test_parameter_names_shapes_and_deferred_input_size_match_jax():
    jl = jrnn.LSTM(8, 2, bidirectional=True, prefix="names_")
    tl = rnn.LSTM(8, 2, bidirectional=True, prefix="names_")
    jnames = sorted(p.name for p in jl.collect_params().values())
    tnames = sorted(p.name for p in tl.collect_params().values())
    assert tnames == jnames
    assert tl.l0_i2h_weight.shape == (32, 0)      # deferred until a forward
    tl.initialize(ctx=CPU)
    tl(nd.array(np.zeros((2, 1, 3), np.float32), ctx=CPU))
    assert tl.l0_i2h_weight.shape == (32, 3)
    assert tl.l1_i2h_weight.shape == (32, 16)
    assert "LSTM(lstm, 2 layers, hidden=8, bidirectional)" == repr(tl)


def test_recurrent_cells_wait_for_their_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        rnn.LSTMCell
    with pytest.raises(AttributeError):
        rnn.NoSuchLayer


def test_lstm_wordlm_trunk_matches_the_committed_golden():
    """``tests/test_reference_interchange.py``'s ``_lstm_wordlm_trunk``,
    built on the port: numpy's global RNG seeded with 1234, Xavier
    (gaussian, magnitude 2) drawn in gluon's order."""
    np.random.seed(1234)
    net = rnn.LSTM(64, num_layers=2, prefix="lmgold_")
    net.initialize(mx.init.Xavier(rnd_type="gaussian", magnitude=2.0),
                   ctx=CPU)
    x = nd.array(np.random.RandomState(13).rand(5, 2, 32).astype(np.float32),
                 ctx=CPU)
    out = net(x).asnumpy().reshape(2, -1)
    assert np.isfinite(out).all()
    want = np.load(GOLDEN)["out"]
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
