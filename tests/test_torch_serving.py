"""The PyTorch port's serving plane: wire codec, bucketing, the continuous
batcher (mirroring tests/test_serving.py), checkpoints exported by either
package and served by the other, ModelServer + ServingClient end to end on
the CPU, and the wire between the two packages in both directions.

Model outputs are compared at rtol = atol = 1e-5 (fp32 on both sides,
another summation order); the server runs with ``device="cpu"``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.serving import scheduler, wire

RTOL = ATOL = 1e-5
BERT_CFG = dict(vocab_size=40, units=16, hidden_size=32, num_layers=2,
                num_heads=2, max_length=64)


# ------------------------------------------------------------------ wire
def test_wire_roundtrip_and_byte_identity_with_jax():
    arrays = {"ids": np.arange(12, dtype=np.int32).reshape(3, 4),
              "mask": np.ones((3, 4), np.float32),
              "flag": np.array([True, False, True])}
    manifest, payload = wire.pack_arrays(arrays)
    jmanifest, jpayload = jserving.wire.pack_arrays(arrays)
    assert manifest == jmanifest and payload == jpayload
    out = wire.unpack_arrays(jmanifest, jpayload)
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k], v)
        assert out[k].dtype == v.dtype


def test_wire_rejects_object_dtype_and_bad_manifest():
    with pytest.raises(ValueError):
        wire.pack_arrays({"x": np.array(["a", "b"], object)})
    manifest, payload = wire.pack_arrays({"x": np.zeros(4, np.float32)})
    manifest[0]["shape"] = [400]
    with pytest.raises(ValueError):
        wire.unpack_arrays(manifest, payload)
    with pytest.raises(ValueError):
        wire.unpack_arrays([{"name": "x", "shape": [-1], "dtype": "<f4"}],
                           b"")
    with pytest.raises(ValueError):
        wire.unpack_arrays([{"name": "x", "shape": [1], "dtype": "O"}],
                           b"\0" * 8)


def test_rpc_sockets_take_the_receive_buffer_knob():
    import socket
    from incubator_mxnet_tpu_torch.kvstore import rpc
    srv = rpc.Server(lambda meta, payload: ({"n": len(payload)}, b"")).start()
    try:
        # what the OS grants for the request: Linux caps it at rmem_max and
        # reports double the granted size
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                         rpc.RCVBUF_BYTES)
        granted = probe.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        probe.close()
        conn = rpc.Connection(srv.addr)
        assert conn.call({"op": "x"}, b"\0" * 5)[0] == {"n": 5}
        sock = conn._sock
        assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) \
            == granted
        conn.close()
    finally:
        srv.stop()


# ------------------------------------------------------------- bucketing
def test_bucket_helpers_match_jax(monkeypatch):
    buckets = (16, 32, 128)
    for n in (1, 16, 17, 128, 129):
        assert scheduler.bucket_for(n, buckets) \
            == jserving.scheduler.bucket_for(n, buckets)
    assert [scheduler.pad_batch_rows(n) for n in (1, 2, 3, 5, 8)] \
        == [1, 2, 4, 8, 8]
    a = np.ones((2, 5), np.int32)
    p = scheduler.pad_to_bucket(a, 8, pad_value=7)
    np.testing.assert_array_equal(
        p, jserving.scheduler.pad_to_bucket(a, 8, pad_value=7))
    with pytest.raises(ValueError):
        scheduler.pad_to_bucket(a, 4)
    assert scheduler.pad_to_bucket(np.ones(3), 8).shape == (3,)
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "8, 64,8")
    assert scheduler.default_buckets() == (8, 64)
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "0,8")
    with pytest.raises(ValueError):
        scheduler.default_buckets()


def test_request_validates_leading_dim():
    with pytest.raises(ValueError):
        scheduler.Request("m", {})
    with pytest.raises(ValueError):
        scheduler.Request("m", {"a": np.zeros((2, 3)), "b": np.zeros((3, 3))})
    r = scheduler.Request("m", {"a": np.zeros((2, 5)), "b": np.zeros(2)})
    assert r.rows == 2 and r.length == 5


# ------------------------------------------------------------ batcher
def _echo_forward(calls=None):
    def fn(batch, bucket):
        if calls is not None:
            calls.append((next(iter(batch.values())).shape[0], bucket))
        return {"y": batch["x"] * 2}
    return fn


def test_batcher_serves_and_scatters_rows_back():
    calls = []
    b = scheduler.ContinuousBatcher("m", _echo_forward(calls), max_batch=8,
                                    buckets=(4, 8), max_wait_ms=0).start()
    try:
        r = b.submit(scheduler.Request("m", {"x": np.arange(6.).reshape(2, 3)}))
        out = r.wait(5.0)
        np.testing.assert_array_equal(out["y"][:, :3],
                                      np.arange(6.).reshape(2, 3) * 2)
        assert out["y"].shape == (2, 4) and calls == [(2, 4)]
        assert b.stats()["forwards"] == {4: 1}
    finally:
        b.stop()


def test_batcher_join_window_coalesces_concurrent_requests():
    calls = []
    b = scheduler.ContinuousBatcher("m", _echo_forward(calls), max_batch=8,
                                    buckets=(4,), max_wait_ms=200).start()
    try:
        reqs = [scheduler.Request("m", {"x": np.full((1, 4), i, np.float32)})
                for i in range(3)]
        threads = [threading.Thread(target=b.submit, args=(r,))
                   for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        for i, r in enumerate(reqs):
            np.testing.assert_array_equal(r.wait(5.0)["y"],
                                          np.full((1, 4), 2. * i))
        assert calls == [(4, 4)]          # 3 rows, padded to 4, one step
    finally:
        b.stop()


def test_batcher_sheds_expired_and_overloaded():
    release = threading.Event()

    def slow(batch, bucket):
        release.wait(10.0)
        return {"y": batch["x"]}

    b = scheduler.ContinuousBatcher("m", slow, max_batch=2, buckets=(4,),
                                    max_wait_ms=0, queue_depth=1).start()
    try:
        r0 = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))},
                                        deadline=time.monotonic() - 0.1))
        with pytest.raises(scheduler.ShedError) as ei:
            r0.wait(1.0)
        assert ei.value.stage == "queue"
        blocker = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
        time.sleep(0.2)
        keeper = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
        over = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
        with pytest.raises(scheduler.ShedError) as ei:
            over.wait(1.0)
        assert ei.value.stage == "overload"
        release.set()
        blocker.wait(5.0)
        keeper.wait(5.0)
    finally:
        release.set()
        b.stop()


def test_batcher_join_shed_uses_measured_service_time():
    def slow(batch, bucket):
        time.sleep(0.3)
        return {"y": batch["x"]}

    b = scheduler.ContinuousBatcher("m", slow, max_batch=8, buckets=(4,),
                                    max_wait_ms=0).start()
    try:
        first = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4))}, deadline=time.monotonic() + 0.05))
        first.wait(5.0)         # no shed on an unmeasured guess
        late = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4))}, deadline=time.monotonic() + 0.05))
        with pytest.raises(scheduler.ShedError) as ei:
            late.wait(5.0)
        assert ei.value.stage == "join"
        b.reset_service_estimates()
        retry = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4))}, deadline=time.monotonic() + 0.05))
        assert retry.wait(5.0)["y"].shape == (1, 4)
    finally:
        b.stop()


def test_batcher_forward_error_fails_batch_not_worker():
    flaky = {"n": 0}

    def fn(batch, bucket):
        flaky["n"] += 1
        if flaky["n"] == 1:
            raise RuntimeError("boom")
        return {"y": batch["x"]}

    b = scheduler.ContinuousBatcher("m", fn, buckets=(4,),
                                    max_wait_ms=0).start()
    try:
        bad = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(5.0)
        good = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
        assert good.wait(5.0)["y"].shape == (1, 4)
    finally:
        b.stop()


def test_batcher_stop_rejects_and_fails_queued_requests():
    b = scheduler.ContinuousBatcher("m", _echo_forward(), buckets=(4,))
    r = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        r.wait(1.0)
    after = b.submit(scheduler.Request("m", {"x": np.zeros((1, 4))}))
    with pytest.raises(RuntimeError, match="stopped"):
        after.wait(1.0)


def test_batcher_rejects_overlong_and_oversized_requests():
    b = scheduler.ContinuousBatcher("m", _echo_forward(), max_batch=2,
                                    buckets=(4, 8), max_wait_ms=0).start()
    try:
        long = b.submit(scheduler.Request("m", {"x": np.zeros((1, 9))}))
        with pytest.raises(ValueError, match="largest serving bucket"):
            long.wait(1.0)
        big = b.submit(scheduler.Request("m", {"x": np.zeros((3, 4))}))
        with pytest.raises(ValueError, match="exceed max_batch"):
            big.wait(1.0)
        ok = b.submit(scheduler.Request("m", {"x": np.zeros((2, 4))}))
        assert ok.wait(5.0)["y"].shape == (2, 4)
        assert b.stats()["pending"] == 0
    finally:
        b.stop()


def test_batcher_cobatches_only_compatible_signatures_and_drops_cancelled():
    calls = []

    def fn(batch, bucket):
        calls.append(sorted(batch))
        return {k: v * 2 for k, v in batch.items()}

    b = scheduler.ContinuousBatcher("m", fn, max_batch=8, buckets=(4,),
                                    max_wait_ms=0)
    gone = scheduler.Request("m", {"x": np.zeros((1, 4), np.float32)})
    ra = scheduler.Request("m", {"x": np.ones((1, 4), np.float32)})
    rb = scheduler.Request("m", {"z": np.ones((1, 4), np.float32)})
    rc = scheduler.Request("m", {"x": np.ones((1, 4, 2), np.float32)})
    for r in (gone, ra, rb, rc):
        b.submit(r)
    assert gone.cancel("test timeout") and not gone.cancel()
    b.start()
    try:
        np.testing.assert_array_equal(ra.wait(5.0)["x"], 2 * np.ones((1, 4)))
        np.testing.assert_array_equal(rb.wait(5.0)["z"], 2 * np.ones((1, 4)))
        assert rc.wait(5.0)["x"].shape == (1, 4, 2)
        assert calls == [["x"], ["z"], ["x"]]
        with pytest.raises(TimeoutError):
            gone.wait(0)
    finally:
        b.stop()


# ------------------------------------------------- checkpoints and models
def _jax_bert(seed=3):
    np.random.seed(seed)
    m = JaxBERT(prefix="tb_", dropout=0.0, **BERT_CFG)
    m.initialize(mx.init.Normal(0.02))
    m(nd.array(np.zeros((1, 4), np.int32)))
    return m


def _requests(n, lengths, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = lengths[i % len(lengths)]
        out.append({"token_ids": rs.randint(1, 40, (1, L)).astype(np.int32),
                    "token_types": rs.randint(0, 2, (1, L)).astype(np.int32),
                    "valid_mask": np.ones((1, L), np.float32)})
    return out


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A serving checkpoint written by the JAX package's export."""
    d = str(tmp_path_factory.mktemp("jax_export"))
    m = _jax_bert()
    jserving.export_for_serving(d, "bert_encoder", dict(BERT_CFG,
                                                        emit_seq=True), m)
    return d, m


def test_port_loads_a_jax_exported_checkpoint(jax_export):
    d, m = jax_export
    served = serving.load_served_model(d, device="cpu")
    jserved = jserving.load_served_model(d)
    assert served.generation == jserved.generation == 0
    rs = np.random.RandomState(1)
    arrays = {"token_ids": rs.randint(1, 40, (2, 16)).astype(np.int32),
              "valid_mask": (np.arange(16)[None] < np.array([[16], [9]]))
              .astype(np.float32)}
    got = served.encode_fn(arrays, 16)
    want = jserved.encode_fn(arrays, 16)
    for key in ("pooled", "seq"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
    ref = m(nd.array(arrays["token_ids"]), None,
            nd.array(arrays["valid_mask"]))[1].asnumpy()
    np.testing.assert_allclose(got["pooled"], ref, rtol=RTOL, atol=ATOL)


def test_jax_loads_a_port_exported_checkpoint(tmp_path):
    model = BERTModel(device="cpu", dropout=0.0, seed=5, **BERT_CFG)
    serving.export_for_serving(str(tmp_path), "bert_encoder", BERT_CFG,
                               model)
    serving.export_for_serving(str(tmp_path), "bert_encoder", BERT_CFG,
                               model)
    assert serving.read_generation(str(tmp_path))["generation"] == 1
    assert serving.generation_steps(str(tmp_path)) == {0: 0, 1: 1}
    jserved = jserving.load_served_model(str(tmp_path))
    assert jserved.generation == 1
    ids = np.random.RandomState(2).randint(1, 40, (2, 8)).astype(np.int32)
    want = jserved.encode_fn({"token_ids": ids}, 8)["pooled"]
    with torch.inference_mode():
        got = model(torch.from_numpy(ids))[1].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_quantize_none_follows_the_env_knob_in_both(tmp_path, monkeypatch):
    """``load_served_model(quantize=None)`` reads MXTPU_SERVE_INT8, as the
    JAX package's does (the port read None as off), for the same JAX-written
    lstm_lm checkpoint in both packages."""
    from incubator_mxnet_tpu.models.lstm_lm import RNNModel as JaxRNNModel
    cfg = dict(mode="lstm", vocab_size=30, num_embed=8, num_hidden=8,
               num_layers=1)
    m = JaxRNNModel(prefix="tq_", dropout=0.0, **cfg)
    m.initialize(mx.init.Normal(0.02))
    m(nd.array(np.zeros((1, 2), np.int32)), m.begin_state(batch_size=2))
    jserving.export_for_serving(str(tmp_path), "lstm_lm", cfg, m)
    for value, want in (("1", True), ("0", False)):
        monkeypatch.setenv("MXTPU_SERVE_INT8", value)
        assert jserving.load_served_model(str(tmp_path)).quantized is want
        served = serving.load_served_model(str(tmp_path), device="cpu")
        assert served.quantized is want
        assert (served.int8_head is not None) is want
    for explicit in (False, True):          # an explicit choice wins
        assert serving.load_served_model(
            str(tmp_path), quantize=explicit,
            device="cpu").quantized is explicit


def test_loader_guards(tmp_path):
    with pytest.raises(ValueError, match="unknown serving family"):
        serving.export_for_serving(str(tmp_path), "nope", {}, None)
    with pytest.raises(ValueError, match="already registered"):
        serving.serving_family("bert_encoder")(lambda *a: None)
    from incubator_mxnet_tpu_torch.utils.checkpoint import CheckpointManager
    CheckpointManager(str(tmp_path), keep=None, prefix="serve").save(
        0, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="serving stanza"):
        serving.load_served_model(str(tmp_path), device="cpu")


def test_served_model_refuses_out_of_range_ids(jax_export):
    served = serving.load_served_model(jax_export[0], device="cpu")
    with pytest.raises(ValueError, match="token_ids"):
        served.encode_fn({"token_ids": np.array([[1, 40]], np.int32)}, 2)


# ------------------------------------------------------ server + client
@pytest.fixture
def port_server(jax_export):
    srv = serving.ModelServer(device="cpu").load(
        "bert", directory=jax_export[0], buckets=(8, 32), max_wait_ms=20)
    srv.start()
    yield srv
    srv.stop()


def test_model_server_answers_concurrent_requests_in_two_buckets(
        port_server, jax_export):
    reqs = _requests(8, [5, 8, 20, 32])
    replies, errors = {}, []

    def client(ids):
        try:
            with serving.ServingClient(port_server.addr) as c:
                for i in ids:
                    replies[i] = c.infer("bert", reqs[i])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=([i, i + 4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and len(replies) == 8
    model = jax_export[1]
    for i, r in enumerate(reqs):
        L = r["token_ids"].shape[1]
        bucket = 8 if L <= 8 else 32
        assert replies[i]["seq"].shape == (1, bucket, BERT_CFG["units"])
        pad = {k: scheduler.pad_to_bucket(a, bucket) for k, a in r.items()}
        want = model(nd.array(pad["token_ids"]), nd.array(pad["token_types"]),
                     nd.array(pad["valid_mask"]))[1].asnumpy()
        np.testing.assert_allclose(replies[i]["pooled"], want, rtol=RTOL,
                                   atol=ATOL)
    with serving.ServingClient(port_server.addr) as c:
        assert c.ping()["models"] == ["bert"]
        assert c.models()["bert"]["family"] == "bert_encoder"
        fwd = c.stats()["bert"]["batch"]["forwards"]
        assert set(fwd) == {"8", "32"} and sum(fwd.values()) <= 8


def test_model_server_errors_and_deadlines(port_server):
    with serving.ServingClient(port_server.addr) as c:
        assert "# TYPE mxtpu_serving_requests_total counter" in c.metrics()
        with pytest.raises(serving.ServingError, match="no decode path"):
            c.decode("bert", [1, 2, 3])
        with pytest.raises(serving.ServingError, match="unknown serving op"):
            c._call({"op": "serve.nope"})
        with pytest.raises(serving.ServingError, match="not loaded"):
            c.infer("other", _requests(1, [4])[0])
        with pytest.raises(serving.DeadlineExceeded):
            c.infer("bert", _requests(1, [4])[0], deadline_ms=0)
        with pytest.raises(serving.ServingError, match="largest serving"):
            c.infer("bert", _requests(1, [33])[0])
        assert c.infer("bert", _requests(1, [4])[0],
                       deadline_ms=30000)["pooled"].shape == (1, 16)


def test_mono_deadline_prefers_server_stamp():
    from incubator_mxnet_tpu_torch.serving.server import ModelServer
    assert ModelServer._mono_deadline({"_deadline_mono": 123.5}) == 123.5
    assert ModelServer._mono_deadline({}) is None
    legacy = ModelServer._mono_deadline({"_deadline": time.time() + 10})
    assert abs(legacy - (time.monotonic() + 10)) < 1.0


# ------------------------------------------------- across the packages
def test_jax_client_against_port_server(port_server, jax_export):
    req = _requests(1, [12], seed=4)[0]
    with jserving.ServingClient(port_server.addr) as c:
        assert c.ping()["models"] == ["bert"]
        got = c.infer("bert", req)
        with pytest.raises(jserving.DeadlineExceeded):
            c.infer("bert", req, deadline_ms=-1)
    pad = {k: scheduler.pad_to_bucket(a, 32) for k, a in req.items()}
    want = jax_export[1](nd.array(pad["token_ids"]),
                         nd.array(pad["token_types"]),
                         nd.array(pad["valid_mask"]))
    np.testing.assert_allclose(got["pooled"], want[1].asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["seq"], want[0].asnumpy(), rtol=RTOL,
                               atol=ATOL)


def test_port_client_against_jax_server(jax_export):
    srv = jserving.ModelServer(telemetry=False).load(
        "bert", directory=jax_export[0], buckets=(8, 32), max_wait_ms=0)
    srv.start()
    try:
        req = _requests(1, [7], seed=5)[0]
        with serving.ServingClient("%s:%d" % tuple(srv.addr)) as c:
            assert c.ping()["models"] == ["bert"]
            got = c.infer("bert", req)
            with pytest.raises(serving.DeadlineExceeded):
                c.infer("bert", req, deadline_ms=0)
    finally:
        srv.stop()
    served = serving.load_served_model(jax_export[0], device="cpu")
    want = served.encode_fn(
        {k: scheduler.pad_to_bucket(a, 8) for k, a in req.items()}, 8)
    for key in ("pooled", "seq"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
