"""Thread-safe labeled metrics registry: Counter / Gauge / Histogram.

Counterpart of ``incubator_mxnet_tpu/telemetry/metrics.py``, with the same
names, semantics and snapshot format: named instruments with label sets, a
process-wide enabled flag, per-bucket exemplars on histograms, and
``snapshot()`` for the exporters in ``telemetry/export.py``.

Cost model: every mutator checks the module-level ``_state["enabled"]``
flag first, so an instrumented call site costs one function call and one
dict lookup when telemetry is off. ``MXTPU_METRICS=1`` enables collection
at import.
"""

import os
import threading
import time

__all__ = ["enable", "disable", "enabled", "counter", "gauge", "histogram",
           "snapshot", "reset", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS"]

_state = {"enabled": False}
_registry = {}          # name -> instrument
_registry_lock = threading.Lock()

# Latency-oriented seconds buckets: 100us .. 60s, roughly log-spaced.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0)


def enable():
    """Turn metric collection on process-wide."""
    _state["enabled"] = True


def disable():
    _state["enabled"] = False


def enabled():
    """Fast gate for instrumented hot paths."""
    return _state["enabled"]


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class _Instrument:
    """Base: a named metric holding one series per label combination."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series = {}   # label-tuple -> value (type-specific)

    def clear(self):
        with self._lock:
            self._series = {}

    def labels(self):
        with self._lock:
            return list(self._series)


class Counter(_Instrument):
    """Monotonically increasing counter (per label set)."""

    kind = "counter"

    def inc(self, delta=1, **labels):
        if not _state["enabled"]:
            return
        if delta < 0:
            raise ValueError("Counter.inc: delta must be >= 0, got %r" % delta)
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + delta

    def value(self, **labels):
        key = _label_key(labels)
        with self._lock:
            return self._series.get(key, 0)

    def snapshot(self):
        with self._lock:
            return {k: v for k, v in self._series.items()}


class Gauge(_Instrument):
    """Point-in-time value that can go up and down."""

    kind = "gauge"

    def set(self, value, **labels):
        if not _state["enabled"]:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, delta=1, **labels):
        if not _state["enabled"]:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + delta

    def dec(self, delta=1, **labels):
        self.inc(-delta, **labels)

    def value(self, **labels):
        key = _label_key(labels)
        with self._lock:
            return self._series.get(key, 0)

    def snapshot(self):
        with self._lock:
            return {k: v for k, v in self._series.items()}


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics).

    Each series is ``[count, sum, per-bucket counts, exemplars]`` where
    bucket i counts observations <= buckets[i]; the implicit +Inf
    bucket is the total count. Bucket edges are configurable
    per-instrument at registration (``buckets=``) — decode-step and
    TTFT latencies saturate the default edges, so the catalog picks
    per-instrument ranges.

    Exemplars (OpenMetrics flavor): ``observe(v, exemplar=trace_id)``
    remembers the most recent trace id that landed in each bucket, so a
    degraded p99 links straight to a concrete sampled request's
    timeline (/tracez?trace_id=). Stored per series, surfaced through
    ``exemplars()`` and the JSON snapshot; the Prometheus text render
    is unchanged.
    """

    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS

    def observe(self, value, exemplar=None, **labels):
        if not _state["enabled"]:
            return
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = [0, 0.0, [0] * len(self.buckets), None]
                self._series[key] = st
            st[0] += 1
            st[1] += value
            counts = st[2]
            idx = len(self.buckets)         # the implicit +Inf bucket
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    counts[i] += 1
                    idx = min(idx, i)
            if exemplar is not None:
                if st[3] is None:
                    st[3] = {}
                st[3][idx] = {"trace_id": exemplar, "value": value,
                              "ts": time.time()}

    def exemplars(self, **labels):
        """{bucket-edge (str, "+Inf" for the overflow bucket):
        {"trace_id", "value", "ts"}} for one series — the newest
        exemplar recorded per bucket."""
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None or len(st) < 4 or not st[3]:
                return {}
            return {self._edge_name(i): dict(ex)
                    for i, ex in st[3].items()}

    def _edge_name(self, idx):
        return "+Inf" if idx >= len(self.buckets) \
            else str(self.buckets[idx])

    def count(self, **labels):
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            return st[0] if st else 0

    def quantile(self, q, **labels):
        """Estimate the q-quantile (0 <= q <= 1) from the cumulative
        buckets, Prometheus histogram_quantile style: find the first
        bucket whose cumulative count reaches rank q*count and
        interpolate linearly inside it. Returns None with no
        observations; ranks beyond the last finite bucket clamp to its
        upper edge (the +Inf bucket has no width to interpolate)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1], got %r" % q)
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None or st[0] == 0:
                return None
            total, counts = st[0], list(st[2])
        rank = q * total
        prev_edge, prev_count = 0.0, 0
        for edge, c in zip(self.buckets, counts):
            if c >= rank:
                span = c - prev_count
                frac = 1.0 if span <= 0 else (rank - prev_count) / span
                return prev_edge + (edge - prev_edge) * frac
            prev_edge, prev_count = edge, c
        return self.buckets[-1]

    def sum(self, **labels):
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            return st[1] if st else 0.0

    def snapshot(self):
        with self._lock:
            return {k: [v[0], v[1], list(v[2])]
                    for k, v in self._series.items()}

    def snapshot_exemplars(self):
        """{label-tuple: {bucket-edge: exemplar dict}} — only series
        that actually carry exemplars appear."""
        with self._lock:
            return {k: {self._edge_name(i): dict(ex)
                        for i, ex in v[3].items()}
                    for k, v in self._series.items()
                    if len(v) > 3 and v[3]}


def _get(cls, name, help, **kwargs):
    with _registry_lock:
        inst = _registry.get(name)
        if inst is not None:
            if type(inst) is not cls:
                raise ValueError(
                    "metric %r already registered as %s, not %s"
                    % (name, inst.kind, cls.kind))
            want = kwargs.get("buckets")
            if want is not None and tuple(sorted(want)) != getattr(
                    inst, "buckets", tuple(sorted(want))):
                raise ValueError(
                    "histogram %r already registered with buckets %r; "
                    "re-registration asked for %r"
                    % (name, inst.buckets, tuple(sorted(want))))
            return inst
        inst = cls(name, help, **kwargs)
        _registry[name] = inst
        return inst


def counter(name, help=""):
    """Get or create the named Counter."""
    return _get(Counter, name, help)


def gauge(name, help=""):
    """Get or create the named Gauge."""
    return _get(Gauge, name, help)


def histogram(name, help="", buckets=None):
    """Get or create the named Histogram."""
    return _get(Histogram, name, help, buckets=buckets)


def instruments():
    """All registered instruments, sorted by name."""
    with _registry_lock:
        return [v for _, v in sorted(_registry.items())]


def reset():
    """Clear every instrument's series (registrations are kept)."""
    for inst in instruments():
        inst.clear()


def snapshot():
    """Plain-dict dump of every instrument, for the JSON exporter.

    Label tuples are rendered as ``k=v,k2=v2`` strings so the result is
    JSON-serializable.
    """
    out = {}
    for inst in instruments():
        series = {}
        exemplars = (inst.snapshot_exemplars()
                     if inst.kind == "histogram" else {})
        for key, val in inst.snapshot().items():
            skey = ",".join("%s=%s" % kv for kv in key)
            if inst.kind == "histogram":
                series[skey] = {"count": val[0], "sum": val[1],
                                "buckets": dict(zip(
                                    [str(b) for b in inst.buckets], val[2]))}
                if key in exemplars:
                    series[skey]["exemplars"] = exemplars[key]
            else:
                series[skey] = val
        out[inst.name] = {"kind": inst.kind, "help": inst.help,
                          "series": series}
    return out


if os.environ.get("MXTPU_METRICS", "") in ("1", "true", "on"):
    enable()
