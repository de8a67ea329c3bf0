"""TCP message layer: length-prefixed JSON + payload frames.

Counterpart of ``incubator_mxnet_tpu/kvstore/rpc.py``, wire-compatible with
it, so a client of either package talks to a server of the other:

    [u32 meta_len][u32 payload_len][meta: UTF-8 JSON object][payload bytes]

The metadata is a JSON object with a string ``op``; tensors ride in the raw
payload. Nothing is unpickled. A server NACKs a request whose
``_deadline_ms`` budget (relative milliseconds) or legacy ``_deadline``
(absolute unix seconds) is already spent, and stamps a live budget onto its
own monotonic clock as ``_deadline_mono`` before the handler runs.

Every connection, client or server side, turns Nagle off and asks for a
fixed receive buffer of ``RCVBUF_BYTES`` (4 MiB). Some TCP stacks
(gVisor's netstack, for one) stall a connection for about 200 ms when,
after a small frame, it receives one
larger than the window it grew for the first: a serving client that gets a
393 KB reply and then a 1.5 MB one hits that on every new connection. A
receive buffer that starts large avoids it. Where the OS caps the request
(Linux: ``net.core.rmem_max``), the buffer is that cap and the OS no longer
grows it on its own.

Observability and resilience as in the JAX package: ``send_msg`` and
``recv_msg`` count wire bytes and are lockdep's blocking chokepoints; a
client call injects the active trace span into the meta and is counted and
timed by op; the server opens a child span from the meta, counts and times
its handler, and counts deadline NACKs. ``Connection.call_idempotent``
retries after any transport error with bounded exponential backoff
(``MXTPU_PS_RETRY_WINDOW`` seconds, 30 by default): stamped with the
connection's client token and a sequence id, the request is applied at
most once by a server whose handler is wrapped in a ``DedupCache``. Four
failpoints (``utils/failpoints.py``) inject the faults it recovers from:
``rpc.send.drop``, ``rpc.recv.drop``, ``rpc.reply.delay`` and
``rpc.reply.drop``. The JAX package's hang watchdog and membership-epoch
notifications belong to its parameter server and are not part of this
port yet.
"""

import itertools
import json
import logging
import os
import socket
import struct
import threading
import time
import uuid

from ..telemetry import catalog as _cat
from ..telemetry import flight as _fl
from ..telemetry import lockdep as _ld
from ..telemetry import metrics as _met
from ..telemetry import tracing as _tr
from ..utils import failpoints as _fp

__all__ = ["ProtocolError", "send_msg", "recv_msg", "request", "Connection",
           "DedupCache", "Server", "tune_socket", "retry_window"]

_log = logging.getLogger(__name__)

_HDR = struct.Struct("<I")

_MAX_META = 64 * 1024 * 1024        # sanity bounds against garbage frames
_MAX_PAYLOAD = 1 << 40

RCVBUF_BYTES = 4 << 20


class ProtocolError(RuntimeError):
    pass


def _deadline_expired(dl):
    """True when an absolute-unix ``_deadline`` has passed; a malformed
    stamp never expires."""
    try:
        return time.time() > float(dl)
    except (TypeError, ValueError):
        return False


def _budget_expired(ms):
    """True when a relative ``_deadline_ms`` budget arrived non-positive;
    a malformed stamp never expires."""
    try:
        return float(ms) <= 0.0
    except (TypeError, ValueError):
        return False


def tune_socket(sock):
    """Nagle off and an ``RCVBUF_BYTES`` receive buffer, on a connected
    TCP socket."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
    return sock


def send_msg(sock, obj, payload=b""):
    """obj: JSON-serializable metadata dict; payload: raw bytes."""
    _ld.check_blocking("rpc.send")     # lockdep chokepoint
    meta = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    frame = _HDR.pack(len(meta)) + _HDR.pack(len(payload)) + meta + payload
    sock.sendall(frame)
    _cat.rpc_bytes_sent.inc(len(frame))


def _recv_exact(sock, n):
    """Exactly n bytes; None on a clean close before any byte, the short
    prefix if the peer dies mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else bytes(buf)
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock):
    """(meta, payload), or (None, None) on a clean close at a frame
    boundary; a peer dying mid-frame raises ProtocolError."""
    _ld.check_blocking("rpc.recv")     # lockdep chokepoint
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None, None
    if len(hdr) < 8:
        raise ProtocolError("connection closed mid-header (%d/8 bytes)"
                            % len(hdr))
    meta_len, payload_len = _HDR.unpack(hdr[:4])[0], _HDR.unpack(hdr[4:])[0]
    if meta_len > _MAX_META or payload_len > _MAX_PAYLOAD:
        raise ProtocolError("frame size out of bounds (%d, %d)"
                            % (meta_len, payload_len))
    meta_raw = _recv_exact(sock, meta_len)
    if meta_raw is None or len(meta_raw) < meta_len:
        raise ProtocolError("connection closed mid-metadata")
    payload = _recv_exact(sock, payload_len) if payload_len else b""
    if payload is None or len(payload) < payload_len:
        raise ProtocolError("connection closed mid-payload")
    try:
        meta = json.loads(meta_raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError("bad metadata frame: %s" % e) from e
    if not isinstance(meta, dict) or not isinstance(meta.get("op", ""), str):
        raise ProtocolError("metadata must be a JSON object")
    _cat.rpc_bytes_received.inc(8 + meta_len + payload_len)
    return meta, payload


def request(addr, obj, payload=b"", timeout=60.0):
    """One-shot request/response on a new connection."""
    with tune_socket(socket.create_connection(addr, timeout=timeout)) as s:
        send_msg(s, obj, payload)
        return recv_msg(s)


def retry_window():
    """Seconds a retryable call keeps retrying before surfacing the error
    (MXTPU_PS_RETRY_WINDOW; 0 = fail fast, ``call_idempotent`` is then
    exactly ``call``)."""
    return float(os.environ.get("MXTPU_PS_RETRY_WINDOW", "30"))


class Connection:
    """Persistent connection: one outstanding request/response at a time
    (the lock serializes them), reconnecting on the next call after a
    transport error. ``call`` does not resend a failed request, which may
    have been applied; ``call_idempotent`` does, deduplicated."""

    def __init__(self, addr, timeout=120.0):
        self._addr = tuple(addr)
        self._timeout = timeout
        self._sock = None
        # this lock's purpose is to serialize the blocking exchange, so the
        # lockdep witness exempts it
        self._lock = _ld.allow_blocking(threading.Lock())
        # idempotency identity: servers dedup retried requests by (client
        # token, seq); the token survives reconnects
        self._client_token = uuid.uuid4().hex
        self._seq = itertools.count(1)
        self._connected_once = False

    def _ensure(self):
        if self._sock is None:
            if self._connected_once:
                _cat.rpc_reconnects.inc()
                _fl.record("rpc.reconnect", addr="%s:%s" % self._addr)
            self._sock = tune_socket(socket.create_connection(
                self._addr, timeout=self._timeout))
            self._connected_once = True

    def set_addr(self, addr):
        """Repoint at a new peer address; the next call reconnects there.
        The dedup identity is unchanged."""
        addr = tuple(addr)
        with self._lock:
            if addr != self._addr:
                self._addr = addr
                self._close_locked()

    def call(self, obj, payload=b"", timeout=None):
        if _tr.current() is not None and _tr.TRACE_KEY not in obj:
            obj = dict(obj)     # don't mutate the caller's meta
            _tr.inject(obj)
        if not _met.enabled():
            return self._call(obj, payload, timeout)
        op = obj.get("op", "")
        t0 = time.perf_counter()
        try:
            out = self._call(obj, payload, timeout)
        except Exception:       # noqa: BLE001 - count, then re-raise
            _cat.rpc_client_requests.inc(op=op, status="error")
            raise
        _cat.rpc_client_seconds.observe(time.perf_counter() - t0, op=op)
        _cat.rpc_client_requests.inc(op=op, status="ok")
        return out

    def _call(self, obj, payload=b"", timeout=None):
        # the lock is held across connect, send and receive: one
        # connection carries one request/response pair at a time
        with self._lock:
            try:
                self._ensure()
                if _fp.failpoint("rpc.send.drop"):
                    # lost before the wire: never applied
                    self._close_locked()
                    raise OSError("failpoint: rpc.send.drop")
                if timeout is not None:
                    self._sock.settimeout(timeout)
                send_msg(self._sock, obj, payload)
                if _fp.failpoint("rpc.recv.drop"):
                    # lost after the wire: applied, the reply never seen
                    self._close_locked()
                    raise OSError("failpoint: rpc.recv.drop")
                meta, data = recv_msg(self._sock)
            except (OSError, ProtocolError):
                # no resend here: the request may have been applied
                self._close_locked()
                raise
            finally:
                if timeout is not None and self._sock is not None:
                    self._sock.settimeout(self._timeout)
            if meta is None:
                self._close_locked()
                raise ConnectionError("peer %s closed the connection"
                                      % (self._addr,))
            return meta, data

    def call_idempotent(self, obj, payload=b"", timeout=None, window=None,
                        dedup=True, on_retry=None):
        """``call`` wrapped in bounded exponential backoff with reconnect.

        With ``dedup=True`` (mutating ops) the request is stamped with this
        connection's client token and a monotonic sequence id; a server
        running a ``DedupCache`` applies each seq at most once and replays
        the cached reply for resends, so retrying after ANY transport error
        is safe, the reply-lost case included. ``dedup=False`` is for
        naturally idempotent reads: retried verbatim, never cached.

        ``window`` seconds of retrying (default ``retry_window()``; 0 = fail
        fast). ``on_retry(connection)`` runs before each resend (to
        re-resolve a restarted peer's address)."""
        if dedup:
            obj = dict(obj)
            obj["_client"] = self._client_token
            obj["_seq"] = next(self._seq)
        if window is None:
            window = retry_window()
        if window <= 0:
            return self.call(obj, payload, timeout=timeout)
        deadline = time.monotonic() + window
        delay = 0.05
        while True:
            try:
                return self.call(obj, payload, timeout=timeout)
            except (OSError, ProtocolError):
                if time.monotonic() + delay > deadline:
                    raise
                _cat.rpc_retries.inc(op=obj.get("op", ""))
                _fl.record("rpc.retry", op=obj.get("op", ""),
                           addr="%s:%s" % self._addr,
                           delay_s=round(delay, 3))
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
                if on_retry is not None:
                    try:
                        on_retry(self)
                    except Exception:   # noqa: BLE001 - the resolver
                        _log.debug(     # failing must not mask the retry
                            "on_retry failed", exc_info=True)

    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self._close_locked()


class DedupCache:
    """Per-client reply cache making seq-stamped requests idempotent.

    ``wrap(handler)`` returns a handler that applies each (client token,
    seq) at most once and replays the cached reply for resends: the server
    half of ``Connection.call_idempotent``. Requests without a seq stamp
    pass straight through. Calls from ONE client serialize on that client's
    lock, so a resend racing its original never double-applies; distinct
    clients stay parallel. The last ``window`` replies are kept per client.
    ``state()`` / ``load_state()`` snapshot and restore the cache in the
    JAX package's format."""

    def __init__(self, window=128):
        self._window = int(window)
        self._lock = threading.Lock()
        self._clients = {}   # token -> (client lock, {seq: (meta, payload)})

    def _client(self, token):
        with self._lock:
            ent = self._clients.get(token)
            if ent is None:
                ent = (threading.Lock(), {})
                self._clients[token] = ent
            return ent

    def wrap(self, handler):
        def wrapped(meta, payload):
            token, seq = meta.get("_client"), meta.get("_seq")
            if token is None or seq is None:
                return handler(meta, payload)
            lock, cache = self._client(token)
            with lock:
                hit = cache.get(seq)
                if hit is not None:
                    _cat.rpc_dedup_hits.inc()
                    return hit
                out = handler(meta, payload)
                cache[seq] = out
                while len(cache) > self._window:
                    cache.pop(min(cache))
                return out
        return wrapped

    def state(self):
        with self._lock:
            items = list(self._clients.items())
        out = {}
        for token, (lock, cache) in items:
            with lock:
                out[token] = {
                    str(seq): [meta, payload.hex() if payload else ""]
                    for seq, (meta, payload) in cache.items()}
        return out

    def load_state(self, state):
        with self._lock:
            self._clients = {
                token: (threading.Lock(),
                        {int(seq): (meta, bytes.fromhex(hexpay))
                         for seq, (meta, hexpay) in cache.items()})
                for token, cache in (state or {}).items()}


class Server:
    """Threaded request server: handler(meta, payload) -> (meta, payload).
    A handler exception becomes an ``{"error": "Type: message"}`` reply."""

    def __init__(self, handler, host="127.0.0.1", port=0):
        self._handler = handler
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.addr = self._srv.getsockname()
        self._stop = threading.Event()
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.5)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            tune_socket(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        with self._conns_lock:
            self._conns.add(conn)
        try:
            peer = conn.getpeername()[0]
        except OSError:
            peer = ""
        try:
            while not self._stop.is_set():
                meta, payload = recv_msg(conn)
                if meta is None:
                    return
                meta["_peer"] = peer    # server-authoritative
                op = meta.get("op", "")
                dl = meta.get("_deadline")
                ms = meta.get("_deadline_ms")
                if (dl is not None and _deadline_expired(dl)) or \
                        (ms is not None and _budget_expired(ms)):
                    _cat.rpc_deadline_dropped.inc(op=op)
                    _fl.record("rpc.deadline_dropped", op=op, peer=peer)
                    send_msg(conn, {"error": "DeadlineExceeded: request "
                                    "deadline already expired",
                                    "deadline_exceeded": True}, b"")
                    continue
                if ms is not None:
                    try:
                        meta["_deadline_mono"] = (time.monotonic()
                                                  + float(ms) / 1e3)
                    except (TypeError, ValueError):
                        pass
                enabled = _met.enabled()
                t0 = time.perf_counter() if enabled else 0.0
                status = "ok"
                try:
                    with _tr.from_meta("rpc." + op, meta, peer=peer):
                        out_meta, out_payload = self._handler(meta, payload)
                except Exception as e:  # noqa: BLE001 - reply, don't die
                    _log.debug("rpc handler failed", exc_info=True)
                    status = "error"
                    out_meta, out_payload = (
                        {"error": "%s: %s" % (type(e).__name__, e)}, b"")
                if enabled:
                    _cat.rpc_server_seconds.observe(
                        time.perf_counter() - t0, op=op)
                    _cat.rpc_server_requests.inc(op=op, status=status)
                d = _fp.failpoint("rpc.reply.delay")
                if d:
                    time.sleep(float(d))
                if _fp.failpoint("rpc.reply.drop"):
                    # applied, reply never sent: the client retries with a
                    # dedupable seq to resolve the ambiguity
                    return
                send_msg(conn, out_meta, out_payload)
        except (OSError, EOFError, ProtocolError):
            pass
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def stop(self):
        """Stop accepting and drop live connections."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
