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
re-admit: ``deploy``). Metrics and tracez come with the telemetry plane
(ROADMAP Queue 1 item 13) and answer with an error that says so.

``device=None`` is ``cuda:0`` and raises without CUDA; ``device="cpu"``
serves through the plain path.
"""

import os
import threading
import time

from ..context import resolve_device
from ..kvstore import rpc as _rpc
from .decode import DecodeLoop, DecodeRequest, check_token_ids
from .loader import (ServedModel, load_generation_params, load_served_model,
                     read_generation)
from .scheduler import ContinuousBatcher, Request, ShedError
from .wire import pack_arrays, unpack_arrays

__all__ = ["ModelServer"]

_LATER_OPS = ("serve.metrics", "serve.tracez")


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
    def __init__(self, host="127.0.0.1", port=0, device=None):
        self.device = resolve_device(device)
        self._models = {}
        self._lock = threading.Lock()
        self._timeout = float(os.environ.get("MXTPU_SERVE_TIMEOUT", "60"))
        self._rpc = _rpc.Server(self._handle, host=host, port=port)
        self.addr = self._rpc.addr

    # ----------------------------------------------------------- lifecycle
    def start(self):
        self._rpc.start()
        return self

    def stop(self):
        self._rpc.stop()
        with self._lock:
            tenants = list(self._models.values())
            self._models = {}
        for t in tenants:
            t.stop()

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
        return self

    def unload(self, name):
        with self._lock:
            tenant = self._models.pop(name, None)
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
        "decode": decode loop stats}}, each scheduler's entry present when
        the model has it."""
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
        host (pinned on a CUDA server), drain the model (never swap
        mid-batch), swap them in place into the tensors every captured
        graph reads, re-admit. ``generation=None`` follows the directory's
        generation pointer; ``directory=None`` is the directory the model
        was loaded from. Deploying the live generation is a no-op; a
        generation that is not retained raises before the drain. Any
        failure re-admits the old weights. The reply carries the drain,
        swap and admit milliseconds (the admission outage)."""
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
        try:
            if not self.drain(name):
                raise RuntimeError(
                    "model %r did not quiesce within the drain deadline; "
                    "swap aborted" % name)
            t1 = time.perf_counter()
            t.served.swap_params(params, generation)
            t2 = time.perf_counter()
        finally:
            self.admit(name)
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
        if op in _LATER_OPS:
            raise ValueError("serving op %r is not supported by the PyTorch "
                             "port yet" % op)
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
