"""Metric exporters: Prometheus text exposition, JSON, periodic flusher.

Counterpart of ``incubator_mxnet_tpu/telemetry/export.py``, byte for byte in
its output. Env-var driven:

  MXTPU_METRICS=1            enable collection at import
  MXTPU_METRICS_EXPORT=PATH  start the periodic flusher writing to PATH
                             ("-" or "stdout" prints instead)
  MXTPU_METRICS_INTERVAL=30  flush period in seconds
  MXTPU_METRICS_FORMAT=prom  "prom" (default) or "json"

The flusher is a daemon thread; an atexit hook writes one final dump so
short-lived jobs still export, and dumps the retained spans
(``MXTPU_TRACE_EXPORT``), the flight ring (``MXTPU_FLIGHT_EXPORT``) and the
memory post-mortem (``MXTPU_MEM_EXPORT``) where those are set.
"""

import atexit
import json
import os
import sys
import threading

from . import metrics as _metrics

__all__ = ["render_prometheus", "render_json", "start_flusher",
           "stop_flusher", "flush"]

_flusher = {"thread": None, "stop": None, "path": None, "fmt": "prom"}
_flusher_lock = threading.Lock()


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key, extra=()):
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in pairs)


def _fmt_value(v):
    if isinstance(v, float):
        return repr(v)
    return str(v)


def render_prometheus():
    """All registered metrics in Prometheus text exposition format."""
    lines = []
    for inst in _metrics.instruments():
        series = inst.snapshot()
        if inst.help:
            lines.append("# HELP %s %s" % (inst.name, inst.help))
        lines.append("# TYPE %s %s" % (inst.name, inst.kind))
        if inst.kind == "histogram":
            for key, (count, total, buckets) in sorted(series.items()):
                # bucket counts are stored cumulatively (observe() bumps
                # every edge >= value), matching Prometheus semantics
                for edge, n in zip(inst.buckets, buckets):
                    lines.append("%s_bucket%s %d" % (
                        inst.name, _fmt_labels(key, [("le", repr(edge))]), n))
                lines.append("%s_bucket%s %d" % (
                    inst.name, _fmt_labels(key, [("le", "+Inf")]), count))
                lines.append("%s_sum%s %s" % (inst.name, _fmt_labels(key),
                                              _fmt_value(total)))
                lines.append("%s_count%s %d" % (inst.name, _fmt_labels(key),
                                                count))
        else:
            for key, value in sorted(series.items()):
                lines.append("%s%s %s" % (inst.name, _fmt_labels(key),
                                          _fmt_value(value)))
    return "\n".join(lines) + "\n"


def render_json(indent=None):
    """All registered metrics as a JSON object string."""
    return json.dumps(_metrics.snapshot(), indent=indent, sort_keys=True)


def flush(path=None, fmt=None):
    """Write one export now. path=None/'-'/'stdout' prints to stdout."""
    fmt = fmt or _flusher["fmt"]
    path = path if path is not None else _flusher["path"]
    text = render_json() if fmt == "json" else render_prometheus()
    if path in (None, "-", "stdout"):
        sys.stdout.write(text)
        if not text.endswith("\n"):
            sys.stdout.write("\n")
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def start_flusher(path=None, interval=30.0, fmt="prom"):
    """Start (or retarget) the periodic exporter thread."""
    if fmt not in ("prom", "json"):
        raise ValueError("MXTPU_METRICS_FORMAT must be 'prom' or 'json', "
                         "got %r" % fmt)
    with _flusher_lock:
        stop_flusher_locked()
        stop = threading.Event()
        _flusher["path"] = path
        _flusher["fmt"] = fmt
        _flusher["stop"] = stop

        def _loop():
            while not stop.wait(interval):
                try:
                    flush(path, fmt)
                except OSError:
                    pass    # transient export-target failure; keep going

        t = threading.Thread(target=_loop, name="mxtpu-metrics-flusher",
                             daemon=True)
        _flusher["thread"] = t
        t.start()
        return t


def stop_flusher_locked():
    if _flusher["stop"] is not None:
        _flusher["stop"].set()
        _flusher["stop"] = None
        _flusher["thread"] = None


def stop_flusher(final_flush=False):
    """Stop the periodic exporter (optionally writing once more)."""
    with _flusher_lock:
        stop_flusher_locked()
    if final_flush:
        flush()


def _atexit_flush():
    if _flusher["thread"] is not None and _metrics.enabled():
        try:
            flush()
        except OSError:
            pass    # export target vanished at shutdown
    # a clean exit must not lose the retained spans / flight events:
    # both dumps are no-ops unless their env knobs are set
    try:
        from . import tracing as _tracing
        _tracing.dump_spans()       # MXTPU_TRACE_EXPORT
    except OSError:
        pass
    try:
        from . import flight as _flight
        _flight.dump()              # MXTPU_FLIGHT_EXPORT
    except OSError:
        pass
    try:
        from . import memz as _memz
        _memz.dump(reason="atexit")  # MXTPU_MEM_EXPORT
    except OSError:
        pass


atexit.register(_atexit_flush)


def _init_from_env():
    target = os.environ.get("MXTPU_METRICS_EXPORT")
    if not target:
        return
    _metrics.enable()
    try:
        interval = float(os.environ.get("MXTPU_METRICS_INTERVAL", "30"))
    except ValueError:
        interval = 30.0
    fmt = os.environ.get("MXTPU_METRICS_FORMAT", "prom")
    start_flusher(target, interval=interval, fmt=fmt)


_init_from_env()
