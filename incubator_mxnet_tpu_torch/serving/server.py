"""Multi-model server over the RPC fabric.

Counterpart of ``incubator_mxnet_tpu/serving/server.py``. One
``kvstore.rpc.Server`` fronts any number of loaded models; each model has
its own scheduler threads, a ``ContinuousBatcher`` for encode and a
``DecodeLoop`` for generation. A connection's handler thread blocks on its
request while the scheduler coalesces the waiting requests into shared
forward steps on the server's device.

Ops: ``serve.ping``, ``serve.models``, ``serve.infer``, ``serve.decode``
(greedy generation through the model's ``DecodeLoop`` over its KV-cache
slot grid), ``serve.stats`` (the schedulers' own counts and each model's
CUDA graphs captured and replayed), and the deploy plane:
``serve.generation``, ``serve.drain``, ``serve.admit`` and
``serve.deploy`` (drain, swap a retained generation's weights in place,
re-admit: ``deploy``), and the telemetry plane: ``serve.metrics`` (the
registry as Prometheus text, or JSON with ``format="json"``) and
``serve.tracez`` (the retained spans, or with ``trace_id`` that request's
stitched journey timeline). ``serve.stats`` also carries each model's
p50/p99 latency, mean batch occupancy and request counts from the
histograms.

Telemetry is on by default, as in the JAX package (``telemetry=False``
leaves the metrics off unless ``MXTPU_METRICS`` is set). With the metrics
on, each CUDA graph capture counts under
``mxtpu_jit_compiles_total{where="serving"}``, so a live weight swap can be
shown to cost zero captures over ``serve.metrics``; the deploy plane
leaves ``deploy.*`` flight records and moves
``deploy_swaps``, ``deploy_seconds``, ``deploy_inflight`` and
``serving_generation``. ``MXTPU_DEBUGZ_PORT`` starts the debug HTTP
server (``telemetry.debugz``).

``device=None`` is ``cuda:0`` and raises without CUDA; ``device="cpu"``
serves through the plain path.
"""

import os
import threading
import time

from ..context import resolve_device
from ..kvstore import rpc as _rpc
from ..telemetry import catalog as _cat
from ..telemetry import debugz as _dbz
from ..telemetry import export as _texport
from ..telemetry import flight as _fl
from ..telemetry import metrics as _met
from ..telemetry import tracing as _tr
from .decode import DecodeLoop, DecodeRequest, check_token_ids
from .loader import (ServedModel, load_generation_params, load_served_model,
                     read_generation)
from .scheduler import ContinuousBatcher, Request, ShedError
from .wire import pack_arrays, unpack_arrays

__all__ = ["ModelServer"]


class _Tenant:
    """One loaded model and its schedulers: a batcher for encode, a decode
    loop for generation, each present when the family has that path, and
    the directory it was loaded from (the deploy source)."""

    def __init__(self, name, served, batcher, decode_loop, directory=None):
        self.name = name
        self.served = served
        self.batcher = batcher
        self.decode_loop = decode_loop
        self.directory = directory

    @property
    def draining(self):
        return any(s is not None and s.draining
                   for s in (self.batcher, self.decode_loop))

    def stop(self):
        for sched in (self.batcher, self.decode_loop):
            if sched is not None:
                sched.stop()


class ModelServer:
    def __init__(self, host="127.0.0.1", port=0, device=None,
                 telemetry=True):
        if telemetry:
            # the capture count is part of the serving product surface: a
            # weight swap must cost zero captures, read over serve.metrics
            _met.enable()
        self.device = resolve_device(device)
        self._models = {}
        self._lock = threading.Lock()
        self._timeout = float(os.environ.get("MXTPU_SERVE_TIMEOUT", "60"))
        self._rpc = _rpc.Server(self._handle, host=host, port=port)
        self.addr = self._rpc.addr

    # ----------------------------------------------------------- lifecycle
    def start(self):
        self._rpc.start()
        _fl.set_identity("serving", 0)
        if _dbz.start_from_env(role="serving") is not None:
            _dbz.set_status("serve_addr", "%s:%s" % self.addr)
            _dbz.set_status("models", lambda: sorted(self._models))
            _dbz.set_status("generations", self.generations)
        return self

    def stop(self):
        self._rpc.stop()
        with self._lock:
            tenants = list(self._models.values())
            self._models = {}
        for t in tenants:
            t.stop()
        _cat.serving_models.set(0)

    # -------------------------------------------------------------- models
    def load(self, name, directory=None, served=None, quantize=None,
             max_batch=None, max_wait_ms=None, buckets=None, slots=None,
             cache_len=None, generation=None):
        """Load a model under ``name`` from a serving checkpoint directory
        (or an already-built ServedModel) onto the server's device and start
        its schedulers: a batcher when the family encodes, a decode loop
        over a cache of ``slots`` slots of ``cache_len`` positions when it
        generates. Unnamed knobs follow the MXTPU_SERVE_* env defaults
        (``MXTPU_SERVE_SLOTS`` 8, ``MXTPU_SERVE_CACHE_LEN`` 512)."""
        if (directory is None) == (served is None):
            raise ValueError("pass exactly one of directory/served")
        if served is None:
            served = load_served_model(directory, quantize=quantize,
                                       generation=generation,
                                       device=self.device)
        elif not isinstance(served, ServedModel):
            raise TypeError("served must be a loader.ServedModel")
        batcher = decode_loop = None
        if served.has_encode:
            batcher = ContinuousBatcher(
                name, served.encode_fn, max_batch=max_batch,
                buckets=buckets, max_wait_ms=max_wait_ms,
                pad_value=served.pad_token).start()
        if served.has_decode:
            n_slots = int(slots if slots is not None else
                          os.environ.get("MXTPU_SERVE_SLOTS", "8"))
            n_len = int(cache_len if cache_len is not None else
                        os.environ.get("MXTPU_SERVE_CACHE_LEN", "512"))
            decode_loop = DecodeLoop(
                name, served.step_fn, served.make_cache(n_slots, n_len),
                pad_token=served.pad_token, prefill_fn=served.prefill_fn,
                prefill_chunk=served.prefill_chunk).start()
        tenant = _Tenant(name, served, batcher, decode_loop,
                         directory=directory)
        with self._lock:
            if name in self._models:
                tenant.stop()
                raise ValueError("model %r is already loaded" % name)
            self._models[name] = tenant
            _cat.serving_models.set(len(self._models))
        _cat.serving_generation.set(int(served.generation), model=name)
        return self

    def unload(self, name):
        with self._lock:
            tenant = self._models.pop(name, None)
            _cat.serving_models.set(len(self._models))
        if tenant is None:
            raise KeyError("model %r is not loaded" % name)
        tenant.stop()

    def reset_service_estimates(self, name):
        """Drop a model's EWMA service estimates (warm-up forwards skew
        them)."""
        t = self._tenant(name)
        for sched in (t.batcher, t.decode_loop):
            if sched is not None:
                sched.reset_service_estimates()

    def served(self, name):
        """The ServedModel loaded under ``name``."""
        return self._tenant(name).served

    def _tenant(self, name):
        with self._lock:
            t = self._models.get(name)
        if t is None:
            raise KeyError("model %r is not loaded (have: %s)"
                           % (name, sorted(self._models)))
        return t

    def stats(self):
        """{model: {"family", "generation", "graphs": CUDA graphs captured
        and replayed (``ServedModel.graph_stats``), "batch": batcher stats,
        "decode": decode loop stats, "p50_s", "p99_s": end-to-end latency
        quantiles, "mean_batch_occupancy", "requests": {ok, shed,
        error}}}, each scheduler's entry present when the model has it and
        the latency and occupancy entries once observed (telemetry on)."""
        with self._lock:
            tenants = list(self._models.items())
        out = {}
        for name, t in tenants:
            ent = {"family": t.served.family,
                   "generation": int(t.served.generation),
                   "graphs": t.served.graph_stats()}
            if t.batcher is not None:
                ent["batch"] = t.batcher.stats()
            if t.decode_loop is not None:
                ent["decode"] = t.decode_loop.stats()
            for q, key in ((0.5, "p50_s"), (0.99, "p99_s")):
                v = _cat.serving_request_seconds.quantile(q, model=name)
                if v is not None:
                    ent[key] = round(v, 6)
            occ = _cat.serving_batch_occupancy
            n = occ.count(model=name)
            if n:
                ent["mean_batch_occupancy"] = round(
                    occ.sum(model=name) / n, 3)
            ent["requests"] = {
                s: _cat.serving_requests.value(model=name, status=s)
                for s in ("ok", "shed", "error")}
            out[name] = ent
        return out

    # ----------------------------------------------------- live deploys
    @staticmethod
    def _drain_timeout():
        return float(os.environ.get("MXTPU_DEPLOY_DRAIN_TIMEOUT_S", "30"))

    def drain(self, name, timeout=None):
        """Fence ``name`` for a swap: new requests shed retriable
        DRAINING, in-flight work finishes (bounded). True = quiesced."""
        t = self._tenant(name)
        timeout = self._drain_timeout() if timeout is None \
            else float(timeout)
        _fl.record("deploy.drain", model=name,
                   generation=t.served.generation)
        # rides the caller's trace when the drain RPC was sampled, so a
        # deploy's admission outage shows on the request timeline
        with _tr.span("deploy.drain", model=name):
            ok = True
            for sched in (t.batcher, t.decode_loop):
                if sched is not None:
                    ok = sched.drain(timeout) and ok
        return ok

    def admit(self, name):
        """Re-open admission on ``name`` after a drain."""
        t = self._tenant(name)
        for sched in (t.batcher, t.decode_loop):
            if sched is not None:
                sched.admit()
        _fl.record("deploy.admit", model=name,
                   generation=t.served.generation)

    def generations(self):
        """{model: {"generation", "draining"}}: what serve.generation
        returns and a rollout coordinator reads."""
        with self._lock:
            tenants = list(self._models.items())
        return {name: {"generation": int(t.served.generation),
                       "draining": t.draining}
                for name, t in tenants}

    def deploy(self, name, generation=None, directory=None):
        """Live weight push: load the target generation's params onto the
        host (pinned on a CUDA server, under the CUDA graph capture lock so
        that no capture of a shape overlaps the pinning; the read from disk
        takes no lock), drain the model (never swap mid-batch), swap them
        in place into the tensors every captured graph reads, re-admit.
        ``generation=None`` follows the directory's generation pointer;
        ``directory=None`` is the directory the model was loaded from.
        Deploying the live generation is a no-op; a generation that is not
        retained raises before the drain. Any failure re-admits the old
        weights. The reply carries the drain, swap and admit milliseconds
        (the admission outage)."""
        t = self._tenant(name)
        directory = directory or t.directory
        if directory is None:
            raise ValueError("model %r was not loaded from a directory; "
                             "pass an explicit deploy directory" % name)
        if generation is None:
            ptr = read_generation(directory)
            if not ptr:
                raise ValueError("no generation pointer under %r"
                                 % directory)
            generation = ptr["generation"]
        generation, prev = int(generation), int(t.served.generation)
        if generation == prev:
            return {"ok": True, "model": name, "generation": generation,
                    "previous": prev, "noop": True}
        # the params land on the host before the drain, so the admission
        # outage is the quiesce and one in-place copy to the device
        params, _meta = load_generation_params(
            directory, generation, pin=self.device.type == "cuda")
        t0 = time.perf_counter()
        t1 = t2 = None
        _cat.deploy_inflight.set(1)
        _fl.record("deploy.start", model=name, generation=generation,
                   previous=prev)
        try:
            if not self.drain(name):
                raise RuntimeError(
                    "model %r did not quiesce within the drain deadline; "
                    "swap aborted" % name)
            t1 = time.perf_counter()
            t.served.swap_params(params, generation)
            t2 = time.perf_counter()
            _fl.record("deploy.swap", model=name, generation=generation,
                       previous=prev)
            _cat.serving_generation.set(generation, model=name)
            _cat.deploy_swaps.inc(model=name, outcome="ok")
        except BaseException:
            _cat.deploy_swaps.inc(model=name, outcome="error")
            _fl.record("deploy.abort", model=name, generation=generation,
                       previous=prev)
            raise
        finally:
            self.admit(name)
            _cat.deploy_inflight.set(0)
            _cat.deploy_seconds.observe(time.perf_counter() - t0,
                                        model=name)
        t3 = time.perf_counter()
        return {"ok": True, "model": name, "generation": generation,
                "previous": prev, "drain_ms": (t1 - t0) * 1e3,
                "swap_ms": (t2 - t1) * 1e3, "admit_ms": (t3 - t2) * 1e3}

    # ------------------------------------------------------------- handler
    def _handle(self, meta, payload):
        op = meta.get("op", "")
        if op == "serve.ping":
            with self._lock:
                names = sorted(self._models)
            return {"ok": True, "models": names, "addr": list(self.addr)}, b""
        if op == "serve.models":
            with self._lock:
                tenants = list(self._models.items())
            return {"models": {name: {"family": t.served.family,
                                      "config": t.served.config,
                                      "quantized": t.served.quantized,
                                      "modes": [m for m, on in (
                                          ("encode", t.served.has_encode),
                                          ("decode", t.served.has_decode))
                                          if on]}
                               for name, t in tenants}}, b""
        if op == "serve.infer":
            return self._infer(meta, payload)
        if op == "serve.decode":
            return self._decode(meta, payload)
        if op == "serve.stats":
            return {"stats": self.stats()}, b""
        if op == "serve.generation":
            return {"generations": self.generations()}, b""
        if op == "serve.drain":
            drained = self.drain(meta.get("model", ""),
                                 timeout=meta.get("timeout"))
            return {"ok": True, "model": meta.get("model", ""),
                    "drained": drained}, b""
        if op == "serve.admit":
            self.admit(meta.get("model", ""))
            return {"ok": True, "model": meta.get("model", "")}, b""
        if op == "serve.deploy":
            return self.deploy(meta.get("model", ""),
                               generation=meta.get("generation"),
                               directory=meta.get("directory")), b""
        if op == "serve.metrics":
            if meta.get("format") == "json":
                return {"format": "json"}, \
                    _texport.render_json().encode("utf-8")
            return {"format": "prom"}, \
                _texport.render_prometheus().encode("utf-8")
        if op == "serve.tracez":
            # with a trace_id: this server's stitched timeline of that
            # journey (exemplars and flight events carry the ids to ask
            # with); bare: the most recent retained spans
            tid = meta.get("trace_id")
            if tid is not None:
                return {"trace_id": tid, "timeline":
                        _tr.build_timeline(_tr.recent_spans(),
                                           trace_id=tid)}, b""
            n = int(meta.get("limit", 256))
            return {"spans": _tr.recent_spans(n)}, b""
        raise ValueError("unknown serving op %r" % op)

    @staticmethod
    def _mono_deadline(meta):
        """The request's deadline on this server's monotonic clock: the rpc
        layer's ``_deadline_mono`` stamp, else a legacy absolute
        ``_deadline`` converted through the remaining budget."""
        mono = meta.get("_deadline_mono")
        if mono is not None:
            return float(mono)
        dl = meta.get("_deadline")
        if dl is None:
            return None
        return time.monotonic() + (float(dl) - time.time())

    def _wait(self, req):
        timeout = self._timeout
        if req.deadline is not None:
            timeout = min(timeout,
                          max(req.deadline - time.monotonic(), 0.0) + 5.0)
        try:
            result = req.wait(timeout)
        except ShedError as e:
            return self._shed_reply(e), b""
        except TimeoutError as e:
            # nobody reads a late reply: cancel so the scheduler drops it
            # (and frees its decode slot); losing the cancel race means it
            # settled at the buzzer
            if req.cancel("handler timed out after %.1fs" % timeout):
                _cat.serving_requests.inc(model=req.model, status="error")
                return {"error": "Timeout: %s" % e}, b""
            try:
                result = req.wait(0)
            except ShedError as e2:
                return self._shed_reply(e2), b""
        manifest, out_payload = pack_arrays(result)
        return {"ok": True, "arrays": manifest}, out_payload

    @staticmethod
    def _shed_reply(e):
        """Wire shape of a shed: "draining" is retriable, overload is load
        shedding, every other stage is a deadline story."""
        return {"error": str(e), "shed": e.stage,
                "draining": e.stage == "draining",
                "deadline_exceeded": e.stage not in ("overload",
                                                     "draining")}

    def _infer(self, meta, payload):
        name = meta.get("model", "")
        tenant = self._tenant(name)
        if tenant.batcher is None:
            raise ValueError("model %r has no encode path" % name)
        arrays = unpack_arrays(meta.get("arrays", []), payload)
        req = Request(name, arrays, deadline=self._mono_deadline(meta))
        tenant.batcher.submit(req)
        return self._wait(req)

    def _decode(self, meta, payload):
        name = meta.get("model", "")
        tenant = self._tenant(name)
        if tenant.decode_loop is None:
            raise ValueError("model %r has no decode path" % name)
        arrays = unpack_arrays(meta.get("arrays", []), payload)
        if "tokens" not in arrays:
            raise ValueError("decode needs a 'tokens' prompt array")
        vocab = tenant.served.config.get("vocab_size")
        if vocab is not None:
            # refused here, before it can fail the whole decode grid
            check_token_ids(arrays["tokens"], int(vocab))
        req = DecodeRequest(
            name, arrays["tokens"],
            max_new_tokens=int(meta.get("max_new_tokens", 16)),
            eos_id=meta.get("eos_id"),
            deadline=self._mono_deadline(meta))
        tenant.decode_loop.submit(req)
        return self._wait(req)
