"""The PyTorch port's word-level LSTM LM and its ``lstm_lm`` serving family
against the JAX package's, on the CPU.

- ``RNNModel`` (tied and untied, lstm and gru), weights carried across by
  name: logits and states within rtol = atol = 1e-5 (fp32, another
  summation order), under ``autograd.record()`` too.
- A checkpoint exported by the JAX package, loaded by the port's
  ``load_served_model(device="cpu")`` and served through the port's
  ``DecodeLoop`` in fp32 and in int8: the greedy tokens equal the JAX
  family's on the same requests. The requests are queued before either
  loop starts, so both grids admit and co-schedule them alike (the int8
  head quantizes its activations over the whole slot grid).
- A checkpoint exported by the port loads in the JAX package, tied weight
  under both names, and decodes the same tokens there.
- ``ModelServer(device="cpu")`` answers ``ServingClient.decode`` with the
  family's tokens; the family's live weight swap refuses a param set that
  does not match (``tests/test_torch_deploy.py`` swaps).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models.lstm_lm import RNNModel as JaxRNNModel
from incubator_mxnet_tpu.serving import DecodeLoop as JaxDecodeLoop
from incubator_mxnet_tpu.serving import DecodeRequest as JaxDecodeRequest
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd, serving
from incubator_mxnet_tpu_torch.models import RNNModel, lstm_lm_ptb
from incubator_mxnet_tpu_torch.serving import DecodeLoop, DecodeRequest

RTOL = ATOL = 1e-5
CPU = mx.cpu()
LM = dict(mode="lstm", vocab_size=40, num_embed=16, num_hidden=16,
          num_layers=2)
PROMPTS = [[1], [3, 4, 5, 6, 7, 8, 9], [11, 2], [39, 0, 17, 5],
           [8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8], [25, 30, 1]]
NEW = 6


def _jax_model(tie, mode="lstm", sigma=0.3, seed=3):
    np.random.seed(seed)
    cfg = dict(LM, mode=mode, tie_weights=tie)
    m = JaxRNNModel(prefix="jl_", dropout=0.0, **cfg)
    m.initialize(jmx.init.Normal(sigma))
    m(jmx.nd.array(np.zeros((1, 2), np.int32)), m.begin_state(batch_size=2))
    return m, cfg


def _port_from(jm, cfg):
    tm = RNNModel(dropout=0.0, **cfg)
    tm.initialize(mx.init.Zero(), ctx=CPU)
    jp = jm._collect_params_with_prefix()
    tp = tm._collect_params_with_prefix()
    assert sorted(tp) == sorted(jp)
    for k, p in tp.items():
        p.set_data(jp[k].data().asnumpy())
    return tm


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_model_matches_jax(tie, mode):
    jm, cfg = _jax_model(tie, mode)
    tm = _port_from(jm, cfg)
    assert (tm.decoder.weight is tm.encoder.weight) == tie
    rs = np.random.RandomState(1)
    ids = rs.randint(0, LM["vocab_size"], (5, 3)).astype(np.int32)
    n_states = 2 if mode == "lstm" else 1
    h = [(rs.randn(2, 3, 16) * 0.5).astype(np.float32)
         for _ in range(n_states)]
    jout, jst = jm(jmx.nd.array(ids), [jmx.nd.array(a) for a in h])
    with autograd.record():
        tout, tst = tm(nd.array(ids, ctx=CPU),
                       [nd.array(a, ctx=CPU) for a in h])
        tloss = tout.sum()
    assert tout.shape == (5, 3, LM["vocab_size"])
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    # the gradient of a tied weight collects the embedding's and the
    # decoder's parts, as in the JAX package
    jids = jmx.nd.array(ids)
    with jautograd.record():
        jl = jm(jids, [jmx.nd.array(a) for a in h])[0].sum()
    jl.backward()
    tloss.backward()
    jg = jm.encoder.weight.grad().asnumpy()
    np.testing.assert_allclose(tm.encoder.weight.grad().asnumpy(), jg,
                               rtol=RTOL, atol=ATOL)


def test_lstm_lm_ptb_is_the_published_geometry():
    m = lstm_lm_ptb(prefix="ptb_")
    names = {p.name: p.shape for p in m.collect_params().values()}
    assert names["ptb_embed_weight"] == (10000, 650)
    assert names["ptb_rnn_l0_i2h_weight"] == (2600, 650)
    assert names["ptb_rnn_l1_h2h_weight"] == (2600, 650)
    assert m.decoder.weight is m.encoder.weight
    with pytest.raises(ValueError, match="num_embed == num_hidden"):
        RNNModel(num_embed=8, num_hidden=16, tie_weights=True)


def test_dropout_and_embedding_layers():
    drop = mx.gluon.nn.Dropout(0.5)
    x = nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    assert drop(x) is x                       # predict mode: identity
    with autograd.record(), pytest.raises(NotImplementedError,
                                          match="Queue 1 item 5"):
        drop(x)
    emb = mx.gluon.nn.Embedding(5, 3)
    emb.initialize(mx.init.Normal(1.0), ctx=CPU)
    ids = nd.array(np.array([[0, 4], [2, 2]], np.int32), ctx=CPU)
    got = emb(ids).asnumpy()
    np.testing.assert_array_equal(got, emb.weight.data().asnumpy()[
        [[0, 4], [2, 2]]])
    with pytest.raises(ValueError, match="must lie in"):
        emb(nd.array(np.array([5], np.int32), ctx=CPU))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        mx.gluon.nn.Embedding(5, 3, sparse_grad=True)


def _serve(loop_cls, req_cls, served, slots=3):
    loop = loop_cls("lm", served.step_fn, served.make_cache(slots, 64))
    reqs = [loop.submit(req_cls("lm", p, max_new_tokens=NEW))
            for p in PROMPTS]             # queued before the loop starts
    loop.start()
    try:
        return [r.wait(60.0)["tokens"] for r in reqs]
    finally:
        loop.stop()


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    jm, cfg = _jax_model(True)
    d = str(tmp_path_factory.mktemp("lstm_jax"))
    jserving.export_for_serving(d, "lstm_lm", cfg, jm)
    return d, cfg


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_port_serves_a_jax_export_with_the_jax_tokens(jax_export, quantize):
    d, _cfg = jax_export
    jserved = jserving.load_served_model(d, quantize=quantize)
    tserved = serving.load_served_model(d, quantize=quantize, device="cpu")
    assert tserved.has_decode and tserved.quantized == quantize
    assert (tserved.int8_head is not None) == quantize
    want = _serve(JaxDecodeLoop, JaxDecodeRequest, jserved)
    got = _serve(DecodeLoop, DecodeRequest, tserved)
    assert len(set(np.concatenate(want).tolist())) > 3   # not a flat LM
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_one_step_logits_match_jax_in_fp32_and_int8(jax_export):
    d, cfg = jax_export
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, cfg["vocab_size"], 4).astype(np.int32)
    h = (rs.randn(4, 2, 16) * 0.5).astype(np.float32)
    for quantize in (False, True):
        jserved = jserving.load_served_model(d, quantize=quantize)
        tserved = serving.load_served_model(d, quantize=quantize,
                                            device="cpu")
        jc, tc = jserved.make_cache(4, 8), tserved.make_cache(4, 8)
        for _ in range(4):
            jc.alloc()
            tc.alloc()
        for name in ("h", "c"):
            jc.data[name][:] = h
            tc.data[name].copy_(torch.from_numpy(h))
        active = np.ones(4, bool)
        want = jserved.step_fn(tokens, jc, active)
        got = tserved.step_fn(tokens, tc, active)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for name in ("h", "c"):
            np.testing.assert_allclose(tc.data[name].numpy(), jc.data[name],
                                       rtol=RTOL, atol=ATOL)


def test_jax_loads_a_port_export(tmp_path):
    jm, cfg = _jax_model(True, seed=11)
    tm = _port_from(jm, cfg)
    serving.export_for_serving(str(tmp_path), "lstm_lm", cfg, tm)
    jserved = jserving.load_served_model(str(tmp_path), quantize=False)
    tserved = serving.load_served_model(str(tmp_path), quantize=False,
                                        device="cpu")
    np.testing.assert_array_equal(
        jserved.config["vocab_size"], tserved.config["vocab_size"])
    for w, g in zip(_serve(JaxDecodeLoop, JaxDecodeRequest, jserved),
                    _serve(DecodeLoop, DecodeRequest, tserved)):
        np.testing.assert_array_equal(g, w)


def test_model_server_decodes_and_swap_waits(jax_export):
    d, _cfg = jax_export
    tserved = serving.load_served_model(d, quantize=True, device="cpu")
    want = _serve(DecodeLoop, DecodeRequest, tserved, slots=1)
    srv = serving.ModelServer(device="cpu").load(
        "lm", directory=d, quantize=True, slots=1, cache_len=64).start()
    try:
        with serving.ServingClient(srv.addr) as c:
            got = [c.decode("lm", p, max_new_tokens=NEW) for p in PROMPTS]
            with pytest.raises(serving.ServingError, match="must lie in"):
                c.decode("lm", [40], max_new_tokens=2)
    finally:
        srv.stop()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(serving.GenerationMismatchError, match="missing"):
        tserved.params_swapper({})
