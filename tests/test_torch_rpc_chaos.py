"""The PyTorch port's failpoints and idempotent RPC against the JAX
package's, on the CPU.

- ``MXTPU_FAILPOINTS`` specs parse to the same armed failpoints in both
  packages, and malformed ones fail the same way.
- ``Connection.call_idempotent`` retries after a request dropped before the
  wire, a reply lost after it, a server that drops its reply, and a delayed
  reply past the call's timeout, and the request applies once
  (``DedupCache``); an unstamped read is re-executed; a zero retry window
  fails fast. The port's client and the JAX package's server (and the other
  way round) keep that contract over the wire.
- ``DedupCache.state()`` / ``load_state()`` round-trip between the
  packages; a deadline already spent is NACKed and counted.
"""

import socket
import time

import pytest

from incubator_mxnet_tpu.kvstore import rpc as jrpc
from incubator_mxnet_tpu.utils import failpoints as jfp
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.kvstore import rpc as trpc
from incubator_mxnet_tpu_torch.telemetry import catalog as tcat
from incubator_mxnet_tpu_torch.telemetry import flight as tflight
from incubator_mxnet_tpu_torch.utils import failpoints as tfp


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    tfp.reset()
    jfp.reset()


@pytest.mark.parametrize("spec", [
    "a:0.5:3,b,c:1:2:0.25,d:::oops",
    " x , y:0.1 ,z::4:sleep=0.5",
    "rpc.reply.delay:1:1:2.5,rpc.send.drop::2",
    "",
])
def test_failpoint_specs_parse_as_in_the_jax_package(spec):
    tfp.load_env(spec)
    jfp.load_env(spec)
    assert tfp.list_active() == jfp.list_active()


@pytest.mark.parametrize("spec", ["bad:prob", ":1:2", "a:1:x",
                                  "a:1:1:sleep=soon"])
def test_malformed_failpoint_specs_fail_alike(spec):
    errors = []
    for fp in (tfp, jfp):
        with pytest.raises(ValueError) as e:
            fp.load_env(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_failpoint_count_exhausts_context_restores_and_counts():
    ttel.enable()
    fired = tcat.failpoints_triggered.value(name="site")
    try:
        with tfp.active("site", count=2, value=1.5):
            assert tfp.failpoint("site") == 1.5
            assert tfp.failpoint("site") == 1.5
            assert tfp.failpoint("site") is False    # count exhausted
        assert not tfp.is_active("site")
        assert tfp.failpoint("site") is False
        assert tcat.failpoints_triggered.value(name="site") == fired + 2
    finally:
        ttel.disable()


def _applying_server(rpc, dedup=True):
    calls = {"n": 0}

    def handler(meta, payload):
        calls["n"] += 1
        return {"op": "ok", "applied": calls["n"]}, payload

    cache = rpc.DedupCache()
    srv = rpc.Server(cache.wrap(handler) if dedup else handler).start()
    return srv, calls, cache


# client package, server package
PAIRS = [(trpc, trpc), (trpc, jrpc), (jrpc, trpc)]
PAIR_IDS = ["port-port", "port-jax", "jax-port"]


@pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("site", ["rpc.send.drop", "rpc.recv.drop",
                                  "rpc.reply.drop"])
def test_retry_applies_once(client, server, site):
    """Lost before the wire (the retry is the first apply), lost after it
    (applied, reply lost) or dropped by the server after the apply: the
    retried request applies exactly once, and a new request applies."""
    srv, calls, _cache = _applying_server(server)
    # the client's package fires the send/recv sites, the server's the reply
    at = server if site == "rpc.reply.drop" else client
    fps = tfp if at is trpc else jfp
    try:
        conn = client.Connection(srv.addr)
        fps.activate(site, count=1)
        meta, data = conn.call_idempotent({"op": "put"}, b"xyz", window=10)
        assert meta["applied"] == 1 and calls["n"] == 1 and data == b"xyz"
        meta, _ = conn.call_idempotent({"op": "put"}, window=10)
        assert meta["applied"] == 2 and calls["n"] == 2
        conn.close()
    finally:
        srv.stop()


def test_delayed_reply_past_the_timeout_applies_once():
    srv, calls, _cache = _applying_server(trpc)
    ttel.enable()
    retries = tcat.rpc_retries.value(op="put")
    tflight.enable()
    tflight.clear()
    try:
        conn = trpc.Connection(srv.addr)
        tfp.activate("rpc.reply.delay", count=1, value=0.6)
        meta, _ = conn.call_idempotent({"op": "put"}, timeout=0.2,
                                       window=10)
        assert meta["applied"] == 1 and calls["n"] == 1
        assert tcat.rpc_retries.value(op="put") >= retries + 1
        assert tcat.rpc_dedup_hits.value() >= 1
        assert tcat.rpc_reconnects.value() >= 1
        events = [e["event"] for e in tflight.events()]
        assert "rpc.retry" in events and "rpc.reconnect" in events
        conn.close()
    finally:
        srv.stop()
        tflight.disable()
        ttel.disable()


def test_unstamped_read_retry_reexecutes():
    srv, calls, _cache = _applying_server(trpc)
    try:
        conn = trpc.Connection(srv.addr)
        tfp.activate("rpc.recv.drop", count=1)
        conn.call_idempotent({"op": "get"}, window=10, dedup=False)
        assert calls["n"] == 2      # both executions ran
        conn.close()
    finally:
        srv.stop()


def test_retry_window_zero_fails_fast(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_RETRY_WINDOW", "0")
    assert trpc.retry_window() == 0.0
    srv, calls, _cache = _applying_server(trpc)
    try:
        conn = trpc.Connection(srv.addr)
        tfp.activate("rpc.send.drop", count=1)
        with pytest.raises(OSError, match="rpc.send.drop"):
            conn.call_idempotent({"op": "put"})
        assert calls["n"] == 0
        meta, _ = conn.call_idempotent({"op": "put"})
        assert meta["applied"] == 1
        conn.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("src,dst", [(trpc, jrpc), (jrpc, trpc)],
                         ids=["port-to-jax", "jax-to-port"])
def test_dedup_state_round_trips_between_the_packages(src, dst):
    """A cache's snapshot loads into the other package's cache, which then
    replays the applied requests instead of applying them again."""
    calls = {"n": 0}

    def handler(meta, payload):
        calls["n"] += 1
        return {"applied": calls["n"], "op": meta["op"]}, payload

    a = src.DedupCache(window=3)
    wrapped = a.wrap(handler)
    for seq in range(1, 6):
        wrapped({"op": "put", "_client": "c1", "_seq": seq}, b"\x00\x01")
    wrapped({"op": "put", "_client": "c2", "_seq": 1}, b"")
    saved = a.state()
    assert sorted(saved["c1"]) == ["3", "4", "5"]       # the window
    b = dst.DedupCache(window=3)
    b.load_state(saved)
    assert b.state() == saved
    again = b.wrap(handler)
    assert again({"op": "put", "_client": "c1", "_seq": 5}, b"") == \
        ({"applied": 5, "op": "put"}, b"\x00\x01")
    assert calls["n"] == 6                                # replayed
    assert again({"op": "put", "_client": "c1", "_seq": 6}, b"")[0][
        "applied"] == 7
    assert again({"op": "get"}, b"")[0]["applied"] == 8    # unstamped


def test_spent_deadline_is_nacked_and_counted():
    srv, calls, _cache = _applying_server(trpc)
    ttel.enable()
    dropped = tcat.rpc_deadline_dropped.value(op="put")
    try:
        conn = trpc.Connection(srv.addr)
        meta, _ = conn.call({"op": "put", "_deadline_ms": 0})
        assert meta["deadline_exceeded"] and calls["n"] == 0
        assert tcat.rpc_deadline_dropped.value(op="put") == dropped + 1
        conn.call({"op": "put", "_deadline_ms": 5000})
        assert calls["n"] == 1
        assert tcat.rpc_client_requests.value(op="put", status="ok") >= 2
        assert tcat.rpc_bytes_sent.value() > 0
        conn.close()
    finally:
        srv.stop()
        ttel.disable()


def test_sleep_failpoint_stalls_without_dropping():
    srv, _calls, _cache = _applying_server(trpc, dedup=False)
    try:
        tfp.activate("rpc.send.drop", count=1, value="sleep=0.3")
        conn = trpc.Connection(srv.addr)
        t0 = time.monotonic()
        assert conn.call({"op": "ping"})[0]["applied"] == 1
        assert time.monotonic() - t0 >= 0.3
        conn.close()
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="sleep"):
        tfp.activate("rpc.send.drop", value="sleep=not-a-number")


def test_server_survives_a_partial_frame():
    srv, calls, _cache = _applying_server(trpc)
    try:
        with socket.create_connection(srv.addr, timeout=5) as s:
            s.sendall(b"\x05\x00")
        conn = trpc.Connection(srv.addr)
        assert conn.call({"op": "put"})[0]["applied"] == 1
        conn.close()
    finally:
        srv.stop()
