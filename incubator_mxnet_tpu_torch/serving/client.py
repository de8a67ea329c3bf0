"""Client for the serving plane: a thin typed wrapper over
``kvstore.rpc.Connection``.

Counterpart of ``incubator_mxnet_tpu/serving/client.py`` (ping, models,
stats, infer, decode, and the deploy plane: deploy, drain, admit,
generation), wire-compatible with the servers of both packages.
``deadline_ms`` becomes the relative ``_deadline_ms`` budget, which the
server moves onto its own monotonic clock; a shed comes back as
``DeadlineExceeded`` with the stage that dropped it. A DRAINING shed is
retried after a short backoff (or on the next replica when several
addresses are given) within the deadline. One client serializes its calls:
run one per concurrent request stream.

Telemetry: ``infer``, ``decode`` and ``deploy`` open the head-sampled root
span of their request (``client.infer`` / ``client.decode`` /
``client.deploy``; ``MXTPU_TRACE_SAMPLE``), whose ids ride the rpc meta to
the server; ``last_trace_id`` is the sampled call's trace id, and
``tracez(trace_id)`` fetches the server's stitched timeline of it.
``metrics()`` reads the server's registry.
"""

import os
import time

import numpy as np

from ..kvstore.rpc import Connection
from ..telemetry import tracing as _tr
from .wire import pack_arrays, unpack_arrays

__all__ = ["ServingClient", "ServingError", "DeadlineExceeded", "Draining"]


class ServingError(RuntimeError):
    pass


class DeadlineExceeded(ServingError):
    def __init__(self, message, stage="unknown"):
        super().__init__(message)
        self.stage = stage


class Draining(ServingError):
    """The model is draining for a weight swap: retriable, and retried by
    ``infer`` until the retry budget or the deadline runs out."""

    stage = "draining"


def _normalize_addrs(addr):
    def one(a):
        if isinstance(a, str):
            host, _, port = a.rpartition(":")
            return (host or "127.0.0.1", int(port))
        return (str(a[0]), int(a[1]))
    if isinstance(addr, str):
        return [one(addr)]
    addr = list(addr)
    if len(addr) == 2 and isinstance(addr[0], str) \
            and isinstance(addr[1], (int, np.integer)):
        return [one(addr)]
    return [one(a) for a in addr]


class ServingClient:
    """``addr`` is one replica, ``("host", port)`` or ``"host:port"``, or a
    list of replicas."""

    def __init__(self, addr, timeout=120.0, retry_draining=None,
                 retry_backoff_ms=None):
        self._addrs = _normalize_addrs(addr)
        self._timeout = float(timeout)
        self._conns = {}
        self._cur = 0
        #: trace id of the most recent infer/decode/deploy call if it was
        #: head-sampled (MXTPU_TRACE_SAMPLE), else None
        self.last_trace_id = None
        self._retries = int(
            retry_draining if retry_draining is not None
            else os.environ.get("MXTPU_DEPLOY_RETRY_MAX", "40") or 40)
        self._backoff = float(
            retry_backoff_ms if retry_backoff_ms is not None
            else os.environ.get("MXTPU_DEPLOY_RETRY_BACKOFF_MS",
                                "100") or 100) / 1e3

    def close(self):
        for conn in self._conns.values():
            conn.close()
        self._conns = {}

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()

    def _connection(self):
        conn = self._conns.get(self._cur)
        if conn is None:
            conn = self._conns[self._cur] = Connection(
                self._addrs[self._cur], timeout=self._timeout)
        return conn

    def _call(self, meta, payload=b"", deadline_ms=None):
        if deadline_ms is not None:
            meta["_deadline_ms"] = float(deadline_ms)
        rmeta, rpayload = self._connection().call(meta, payload)
        if rmeta.get("draining"):
            raise Draining(rmeta.get("error", "model is draining"))
        if rmeta.get("shed") or rmeta.get("deadline_exceeded"):
            raise DeadlineExceeded(rmeta.get("error", "request shed"),
                                   stage=rmeta.get("shed", "rpc"))
        if rmeta.get("error"):
            raise ServingError(rmeta["error"])
        return rmeta, rpayload

    def _call_retrying(self, meta, payload=b"", deadline_ms=None):
        start = time.monotonic()
        for attempt in range(self._retries + 1):
            budget = deadline_ms
            if deadline_ms is not None:
                budget = deadline_ms - (time.monotonic() - start) * 1e3
                if budget <= 0 and attempt:
                    raise DeadlineExceeded(
                        "deadline exhausted while the model was draining",
                        stage="draining")
            try:
                return self._call(dict(meta), payload, deadline_ms=budget)
            except Draining:
                if attempt >= self._retries:
                    raise
                if len(self._addrs) > 1:
                    self._cur = (self._cur + 1) % len(self._addrs)
                    if (attempt + 1) % len(self._addrs) == 0:
                        time.sleep(self._backoff)
                else:
                    time.sleep(self._backoff)
        raise Draining("retry budget exhausted")    # pragma: no cover

    def ping(self):
        meta, _ = self._call({"op": "serve.ping"})
        return meta

    def models(self):
        meta, _ = self._call({"op": "serve.models"})
        return meta["models"]

    def stats(self):
        meta, _ = self._call({"op": "serve.stats"})
        return meta["stats"]

    def metrics(self, fmt="prom"):
        """The server's telemetry export, as text ("prom" or "json")."""
        _meta, payload = self._call({"op": "serve.metrics", "format": fmt})
        return payload.decode("utf-8")

    def tracez(self, trace_id=None, limit=None):
        """Recent sampled spans on the current replica; with ``trace_id``,
        the stitched timeline dict of that one trace (see
        ``telemetry.tracing.build_timeline``)."""
        req = {"op": "serve.tracez"}
        if trace_id is not None:
            req["trace_id"] = trace_id
        if limit is not None:
            req["limit"] = int(limit)
        meta, _ = self._call(req)
        return meta["timeline"] if trace_id is not None else meta["spans"]

    def infer(self, model, arrays, deadline_ms=None):
        """One-shot forward on ``model``. arrays: name -> (rows, ...) array,
        all with the same leading dim. Returns name -> array."""
        manifest, payload = pack_arrays(arrays)
        with _tr.request_span("client.infer", model=model) as sp:
            self.last_trace_id = sp.trace_id if sp.sampled else None
            meta, rpayload = self._call_retrying(
                {"op": "serve.infer", "model": model, "arrays": manifest},
                payload, deadline_ms=deadline_ms)
        return unpack_arrays(meta["arrays"], rpayload)

    def decode(self, model, prompt, max_new_tokens=16, eos_id=None,
               deadline_ms=None):
        """Greedy-generate after ``prompt`` (1-D int tokens). Returns the
        generated int32 token array (eos, when hit, is its last entry)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        manifest, payload = pack_arrays({"tokens": prompt})
        req = {"op": "serve.decode", "model": model, "arrays": manifest,
               "max_new_tokens": int(max_new_tokens)}
        if eos_id is not None:
            req["eos_id"] = int(eos_id)
        with _tr.request_span("client.decode", model=model,
                              prompt_tokens=int(prompt.size)) as sp:
            self.last_trace_id = sp.trace_id if sp.sampled else None
            meta, rpayload = self._call_retrying(req, payload,
                                                 deadline_ms=deadline_ms)
        return unpack_arrays(meta["arrays"], rpayload)["tokens"]

    # ------------------------------------------------------ deploy plane
    def deploy(self, model, generation=None, directory=None):
        """Drain, swap and re-admit ``model`` on the CURRENT replica (a
        rollout coordinator runs one client per replica). Defaults: the
        generation pointer of the directory the replica loaded from."""
        req = {"op": "serve.deploy", "model": model}
        if generation is not None:
            req["generation"] = int(generation)
        if directory is not None:
            req["directory"] = directory
        with _tr.request_span("client.deploy", model=model) as sp:
            self.last_trace_id = sp.trace_id if sp.sampled else None
            meta, _ = self._call(req)
        return meta

    def drain(self, model, timeout=None):
        req = {"op": "serve.drain", "model": model}
        if timeout is not None:
            req["timeout"] = float(timeout)
        meta, _ = self._call(req)
        return meta

    def admit(self, model):
        meta, _ = self._call({"op": "serve.admit", "model": model})
        return meta

    def generation(self, model=None):
        """{model: {"generation", "draining"}} of the current replica, or
        just ``model``'s entry when named."""
        meta, _ = self._call({"op": "serve.generation"})
        gens = meta["generations"]
        if model is None:
            return gens
        if model not in gens:
            raise ServingError("model %r is not loaded (have: %s)"
                               % (model, sorted(gens)))
        return gens[model]
