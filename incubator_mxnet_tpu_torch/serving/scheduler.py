"""Deadline-aware continuous batcher.

Counterpart of ``incubator_mxnet_tpu/serving/scheduler.py``, with the same
behaviour: between forward steps the batch worker takes whatever is queued,
up to ``max_batch`` rows from ONE shape bucket, pads each request to the
bucket edge, pads the batch to a power of two by repeating its last row,
runs one forward and scatters the rows back. ``max_wait_ms`` bounds the join
window, anchored to the oldest queued arrival. A request whose deadline has
passed at submit, or cannot be met by ``now + EWMA(bucket service time)``
at join, is shed instead of served late. Only requests with the same array
names, dtypes and trailing dims co-batch.

``forward_fn(arrays, bucket)`` is any callable over numpy arrays; the
serving loader builds it from a checkpoint. ``drain()`` fences admission
for a live weight swap (new requests shed with the retriable "draining"
stage, the queue is served out, no forward is left in flight) and
``admit()`` re-opens it. ``stats()`` also counts forwards per bucket.

Telemetry as in the JAX package: sheds are counted by stage and left on
the flight ring; queue wait, batch occupancy, forward time and end-to-end
latency go to the serving histograms; a head-sampled request gets its
``serve.queue``, ``serve.join`` and ``serve.forward`` spans after the fact.
The forward's time is taken around ``forward_fn``, whose results come back
as numpy: the copy to the host waits for the card, so the time covers the
device work, never just its launch. A forward that names its program
(``forward_fn.cost_name(arrays, bucket)``) feeds ``telemetry.costs``: the
program's FLOPs, counted once at its first call under ``MXTPU_COSTS=1``,
over this forward's time give its MFU.
"""

import collections
import itertools
import os
import threading
import time

import numpy as np

from ..telemetry import catalog as _cat
from ..telemetry import costs as _costs
from ..telemetry import flight as _fl
from ..telemetry import metrics as _met
from ..telemetry import tracing as _tr

__all__ = ["Request", "ContinuousBatcher", "ShedError", "bucket_for",
           "default_buckets", "pad_batch_rows", "pad_to_bucket"]

_req_ids = itertools.count(1)


class ShedError(RuntimeError):
    """Request was shed (deadline unmeetable, queue overloaded, or the
    model is draining for a deploy), not served. ``stage`` says where:
    queue | join | overload | decode | capacity | draining. "draining" is
    retriable: the client retries it."""

    def __init__(self, stage, detail=""):
        super().__init__("shed at %s%s" % (stage, ": " + detail
                                           if detail else ""))
        self.stage = stage


def default_buckets():
    """Sequence-length pad targets (MXTPU_SERVE_BUCKETS, ascending)."""
    spec = os.environ.get("MXTPU_SERVE_BUCKETS", "16,32,64,128,256,512")
    out = sorted({int(b) for b in spec.split(",") if b.strip()})
    if not out or out[0] < 1:
        raise ValueError("MXTPU_SERVE_BUCKETS must name positive lengths, "
                         "got %r" % spec)
    return tuple(out)


def bucket_for(length, buckets):
    """Smallest bucket >= length, or None when the request is too long."""
    for b in buckets:
        if length <= b:
            return b
    return None


def pad_batch_rows(n):
    """Round a row count up to the next power of two."""
    p = 1
    while p < n:
        p *= 2
    return p


def pad_to_bucket(a, bucket, pad_value=0):
    """Pad axis 1 (sequence) of (rows, T, ...) up to ``bucket``; 1-D
    per-row arrays pass through untouched."""
    a = np.asarray(a)
    if a.ndim < 2 or a.shape[1] == bucket:
        return a
    if a.shape[1] > bucket:
        raise ValueError("array length %d exceeds bucket %d"
                         % (a.shape[1], bucket))
    pad = [(0, 0)] * a.ndim
    pad[1] = (0, bucket - a.shape[1])
    return np.pad(a, pad, constant_values=pad_value)


class Request:
    """One admitted inference request.

    arrays : dict name -> np.ndarray, leading dim = rows and (for >=2-D
        inputs) axis 1 = sequence length.
    deadline : absolute ``time.monotonic()`` seconds, or None.
    """

    def __init__(self, model, arrays, deadline=None):
        self.id = next(_req_ids)
        self.model = model
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        shapes = {tuple(a.shape[:1]) for a in self.arrays.values()}
        if not self.arrays or len(shapes) != 1:
            raise ValueError("request needs >=1 array, all with the same "
                             "leading (rows) dimension")
        self.rows = int(next(iter(self.arrays.values())).shape[0])
        self.length = max((a.shape[1] for a in self.arrays.values()
                           if a.ndim >= 2), default=1)
        self.signature = tuple(sorted(
            (k, a.dtype.str, a.ndim, a.shape[2:])
            for k, a in self.arrays.items()))
        self.deadline = deadline
        self.arrival = time.monotonic()
        # request-journey tracing: made inside the server's rpc span
        # (rpc.Server wraps the handler in from_meta), so current() is that
        # span; only head-sampled requests carry (trace_id, parent span_id)
        sp = _tr.current()
        self.trace = (sp.trace_id, sp.span_id) \
            if sp is not None and sp.sampled else None
        self._done = threading.Event()
        self._settle = threading.Lock()
        self.result = None
        self.error = None

    # the first complete/fail/cancel wins; each returns whether it settled
    def complete(self, result):
        with self._settle:
            if self._done.is_set():
                return False
            self.result = result
            self._done.set()
            return True

    def fail(self, error):
        with self._settle:
            if self._done.is_set():
                return False
            self.error = error
            self._done.set()
            return True

    def shed(self, stage, detail=""):
        return self.fail(ShedError(stage, detail))

    def cancel(self, detail="caller stopped waiting"):
        """Abandon the request; the batcher discards it on next touch."""
        return self.fail(TimeoutError(detail))

    def wait(self, timeout=None):
        """The result dict, or raise the recorded error (TimeoutError when
        nothing settled in time)."""
        if not self._done.wait(timeout):
            raise TimeoutError("request %d not completed within %ss"
                               % (self.id, timeout))
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def done(self):
        return self._done.is_set()


def shed_request(model, req, stage, detail=""):
    """The telemetry of one shed request (the caller settled it): counted
    by stage, a ``serving.shed`` flight event carrying the request id (and
    the trace id when sampled, so /flightz entries join /tracez), and a
    ``serve.shed`` span for a sampled request."""
    _cat.serving_shed.inc(model=model, stage=stage)
    _cat.serving_requests.inc(model=model, status="shed")
    attrs = {"model": model, "stage": stage, "request_id": req.id}
    if req.trace:
        attrs["trace_id"] = req.trace[0]
        t1 = time.time()
        _tr.record_span(
            "serve.shed", req.trace[0], parent_id=req.trace[1],
            t0=t1 - (time.monotonic() - req.arrival), t1=t1, sampled=True,
            model=model, stage=stage, request_id=req.id, detail=detail)
    _fl.record("serving.shed", **attrs)


class ContinuousBatcher:
    """Per-model scheduler: shape-bucketed queues and one batch worker."""

    def __init__(self, name, forward_fn, max_batch=None, buckets=None,
                 max_wait_ms=None, queue_depth=None, pad_value=0):
        self.name = name
        self._forward = forward_fn
        self._max_batch = int(max_batch if max_batch is not None else
                              os.environ.get("MXTPU_SERVE_MAX_BATCH", "8"))
        self._buckets = tuple(buckets) if buckets else default_buckets()
        wait = (max_wait_ms if max_wait_ms is not None else
                float(os.environ.get("MXTPU_SERVE_MAX_WAIT_MS", "0")))
        self._max_wait = float(wait) / 1e3
        self._depth = int(queue_depth if queue_depth is not None else
                          os.environ.get("MXTPU_SERVE_QUEUE_DEPTH", "256"))
        self._pad_value = pad_value
        self._cond = threading.Condition()
        self._queues = collections.OrderedDict(
            (b, collections.deque()) for b in self._buckets)
        self._pending = 0
        self._ewma = {}                 # bucket -> smoothed service secs
        self._forwards = {}             # bucket -> forwards run
        self._stopping = False
        self._draining = False
        self._in_flight = False         # a forward is running right now
        self._batches = 0
        self._thread = threading.Thread(
            target=self._run, name="serve-batch-%s" % name, daemon=True)

    # ---------------------------------------------------------- admission
    def submit(self, req):
        """Admit a request (returns it). Sheds instead of queueing when its
        deadline already passed or the queue is full."""
        bucket = bucket_for(req.length, self._buckets)
        if bucket is None:
            req.fail(ValueError(
                "sequence length %d exceeds the largest serving bucket %d"
                % (req.length, self._buckets[-1])))
            return req
        if req.rows > self._max_batch:
            req.fail(ValueError(
                "request rows %d exceed max_batch %d - split the request "
                "client-side" % (req.rows, self._max_batch)))
            return req
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            self._shed(req, "queue", "deadline expired before admission")
            return req
        with self._cond:
            if self._stopping:
                req.fail(RuntimeError("batcher %r is stopped" % self.name))
                return req
            if self._draining:
                self._shed(req, "draining",
                           "model is draining for a weight swap; retry")
                return req
            if self._pending >= self._depth:
                self._shed(req, "overload",
                           "queue depth %d reached" % self._depth)
                return req
            self._queues[bucket].append(req)
            self._pending += 1
            self._cond.notify_all()
        return req

    def _shed(self, req, stage, detail=""):
        if req.shed(stage, detail):     # no double count if already done
            shed_request(self.name, req, stage, detail)

    # ---------------------------------------------------------- lifecycle
    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        """Stop the worker; queued-but-unserved requests fail fast."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread.ident is not None:
            self._thread.join(timeout)
        with self._cond:
            for q in self._queues.values():
                while q:
                    q.popleft().fail(
                        RuntimeError("batcher %r stopped" % self.name))
            self._pending = 0

    # ------------------------------------------------------ drain/re-admit
    @property
    def draining(self):
        return self._draining

    def drain(self, timeout=30.0):
        """Fence admission for a live weight swap: new submits shed with
        the RETRIABLE "draining" stage, already-queued requests are served
        out, and the call blocks until nothing is queued and no forward is
        in flight; a swap must never land mid-batch. Past ``timeout``
        seconds the still-queued requests are shed ("draining", so clients
        retry them) and only the in-flight forward is waited for (one more
        ``timeout`` window). True when quiesced; False means a forward is
        STILL running: do not swap."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            self._draining = True
            self._cond.notify_all()     # the worker skips the join window
            while self._pending or self._in_flight:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.05))
            if self._pending:
                for q in self._queues.values():
                    while q:
                        self._shed(q.popleft(), "draining", "not served "
                                   "before the drain deadline; retry")
                self._pending = 0
            while self._in_flight:
                left = deadline + float(timeout) - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def admit(self):
        """Re-open admission after a drain()."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()

    def reset_service_estimates(self):
        """Forget the EWMA service times (early samples carry warm-up)."""
        with self._cond:
            self._ewma.clear()

    def stats(self):
        with self._cond:
            return {
                "pending": self._pending,
                "batches": self._batches,
                "draining": self._draining,
                "per_bucket": {b: len(q) for b, q in self._queues.items()
                               if q},
                "forwards": dict(self._forwards),
                "service_ewma_s": dict(self._ewma),
            }

    # -------------------------------------------------------- batch worker
    def _pick_bucket_locked(self):
        """Bucket whose head request is oldest (global FIFO)."""
        best, best_t = None, None
        for b, q in self._queues.items():
            if q and (best_t is None or q[0].arrival < best_t):
                best, best_t = b, q[0].arrival
        return best

    def _take_locked(self, bucket):
        """Pop signature-compatible requests from one bucket until
        max_batch rows are staged; cancelled requests are dropped."""
        taken, rows, sig = [], 0, None
        q = self._queues[bucket]
        while q:
            head = q[0]
            if head.done:
                q.popleft()
                self._pending -= 1
                continue
            if sig is None:
                sig = head.signature
            elif head.signature != sig:
                break
            if rows + head.rows > self._max_batch:
                break
            q.popleft()
            self._pending -= 1
            taken.append(head)
            rows += head.rows
        return taken, rows

    def _rows_queued_locked(self, bucket):
        return sum(r.rows for r in self._queues[bucket] if not r.done)

    def _run(self):
        while True:
            with self._cond:
                while not self._stopping and self._pending == 0:
                    self._cond.wait(0.1)
                if self._stopping:
                    return
                bucket = self._pick_bucket_locked()
                if bucket is None:
                    continue
                t_pick = time.monotonic()   # queue-wait / join-wait split
                if self._max_wait > 0 and not self._draining:
                    # a drain skips the join window: nothing new is
                    # admitted, so waiting only stretches the outage
                    until = self._queues[bucket][0].arrival + self._max_wait
                    while (not self._stopping and not self._draining
                           and self._rows_queued_locked(bucket)
                           < self._max_batch
                           and time.monotonic() < until):
                        self._cond.wait(max(until - time.monotonic(), 1e-4))
                    if self._stopping:
                        return
                    refreshed = self._pick_bucket_locked()
                    if refreshed is None:
                        continue
                    bucket = refreshed
                taken, _rows = self._take_locked(bucket)
                if taken:
                    self._in_flight = True
                    self._cond.notify_all()
            if taken:
                try:
                    self._serve_batch(bucket, taken, t_pick)
                finally:
                    with self._cond:
                        self._in_flight = False
                        self._cond.notify_all()

    def _serve_batch(self, bucket, taken, t_pick=None):
        now = time.monotonic()
        est = self._ewma.get(bucket, 0.0)   # 0 before the first sample
        live = []
        for r in taken:
            if r.done:
                continue
            if r.deadline is not None and now + est > r.deadline:
                self._shed(r, "join", "needs ~%.3fs, %.3fs left"
                           % (est, r.deadline - now))
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        wall_off = time.time() - now    # monotonic -> epoch, once
        for r in live:
            _cat.serving_queue_seconds.observe(
                now - r.arrival, model=self.name,
                exemplar=r.trace[0] if r.trace else None)
            if r.trace:
                # retroactive journey spans: queue (arrival -> bucket pick)
                # and join (pick -> serve; the coalescing window)
                joined = now if t_pick is None else max(r.arrival, t_pick)
                _tr.record_span(
                    "serve.queue", r.trace[0], parent_id=r.trace[1],
                    t0=r.arrival + wall_off, t1=joined + wall_off,
                    sampled=True, model=self.name, request_id=r.id,
                    bucket=bucket)
                if joined < now:
                    _tr.record_span(
                        "serve.join", r.trace[0], parent_id=r.trace[1],
                        t0=joined + wall_off, t1=now + wall_off,
                        sampled=True, model=self.name, request_id=r.id)
        _cat.serving_batch_occupancy.observe(rows, model=self.name)
        names = sorted(live[0].arrays)
        padded_rows = pad_batch_rows(rows)
        batch = {}
        try:
            for n in names:
                parts = [pad_to_bucket(r.arrays[n], bucket, self._pad_value)
                         for r in live]
                stacked = np.concatenate(parts, axis=0)
                if padded_rows != rows:
                    fill = np.repeat(stacked[-1:], padded_rows - rows,
                                     axis=0)
                    stacked = np.concatenate([stacked, fill], axis=0)
                batch[n] = stacked
            t0 = time.perf_counter()
            out = self._forward(batch, bucket)
            dt = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - one bad batch fails its
            # own requests, never the worker loop
            for r in live:
                if r.fail(e):
                    _cat.serving_requests.inc(model=self.name,
                                              status="error")
            return
        with self._cond:
            self._batches += 1
            self._forwards[bucket] = self._forwards.get(bucket, 0) + 1
            prev = self._ewma.get(bucket)
            self._ewma[bucket] = dt if prev is None else \
                0.7 * prev + 0.3 * dt
        _cat.serving_forward_seconds.observe(dt, model=self.name,
                                             bucket=str(bucket))
        t_done = time.time()
        for r in live:
            if r.trace:
                _tr.record_span(
                    "serve.forward", r.trace[0], parent_id=r.trace[1],
                    t0=t_done - dt, t1=t_done, sampled=True,
                    model=self.name, request_id=r.id, bucket=bucket,
                    batch_rows=rows)
        if _met._state["enabled"]:
            # tokens consumed per second always; MFU when the program's
            # cost was counted (MXTPU_COSTS=1, see telemetry.costs)
            if dt > 0:
                _cat.model_tokens_per_sec.set(
                    padded_rows * bucket / dt,
                    name="serving.forward/%s" % self.name)
            cost_name = getattr(self._forward, "cost_name", None)
            if cost_name is not None:
                _costs.observe(cost_name(batch, bucket), dt)
        offset = 0
        for r in live:
            res = {k: np.asarray(v)[offset:offset + r.rows]
                   for k, v in out.items()}
            offset += r.rows
            if r.complete(res):
                _cat.serving_requests.inc(model=self.name, status="ok")
                _cat.serving_request_seconds.observe(
                    time.monotonic() - r.arrival, model=self.name,
                    exemplar=r.trace[0] if r.trace else None)
