"""Flight recorder: bounded ring buffer of structured fleet events.

Counterpart of ``incubator_mxnet_tpu/telemetry/flight.py``. Answers "what
happened in the seconds before this process died" without the volume (or
the enable cost) of full tracing. Producers call ``record(event, **attrs)``
at interesting edges (rpc retries, reconnects and deadline NACKs, serving
sheds and retirements, deploy drains, swaps and aborts, KV pool pressure,
OOMs, lockdep violations, failed cost counts) and the newest
``MXTPU_FLIGHT_MAX_EVENTS`` events are kept in memory.

``dump()`` writes the ring as JSONL when an unhandled exception reaches
``sys.excepthook`` or SIGTERM arrives (both hooks installed by
``install_crash_hooks()`` when ``MXTPU_FLIGHT_EXPORT`` is set); the
telemetry atexit flusher also calls it, so a clean exit keeps its final
seconds too.

Cheap when off: ``record()`` is one predicate check (the default). Enable
with ``MXTPU_FLIGHT=1`` / ``MXTPU_FLIGHT_EXPORT=<path>`` or
``flight.enable()``. Stdlib-only; safe to import anywhere.
"""

import json
import os
import signal
import sys
import threading
import time
from collections import deque

__all__ = ["enable", "disable", "enabled", "record", "events", "clear",
           "set_identity", "dump", "dump_path", "install_crash_hooks"]

_state = {"enabled": False, "role": None, "rank": None}
_lock = threading.Lock()


def _default_max_events():
    try:
        return max(16, int(os.environ.get("MXTPU_FLIGHT_MAX_EVENTS", "2048")))
    except ValueError:
        return 2048


_ring = deque(maxlen=_default_max_events())


def enable():
    _state["enabled"] = True


def disable():
    _state["enabled"] = False


def enabled():
    return _state["enabled"]


def set_identity(role=None, rank=None):
    """Stamp every subsequent event with this process's fleet identity."""
    if role is not None:
        _state["role"] = role
    if rank is not None:
        _state["rank"] = rank


def record(event, **attrs):
    """Append one structured event to the ring.  One predicate when off."""
    if not _state["enabled"]:
        return
    rec = {"ts": time.time(), "role": _state["role"],
           "rank": _state["rank"], "event": event}
    if attrs:
        rec["attrs"] = attrs
    with _lock:
        _ring.append(rec)
    from . import metrics as _m
    if _m._state["enabled"]:
        from . import catalog as _cat
        _cat.flight_events.inc(event=event)


def events(n=None):
    """Newest-last list of retained events."""
    with _lock:
        evs = list(_ring)
    return evs[-int(n):] if n else evs


def clear():
    with _lock:
        _ring.clear()


def dump_path():
    return os.environ.get("MXTPU_FLIGHT_EXPORT") or None


def dump(path=None, reason=None):
    """Write retained events as JSONL (atomic).  ``path`` defaults to
    ``MXTPU_FLIGHT_EXPORT``; no-op (returns None) when neither is set."""
    path = path or dump_path()
    if not path:
        return None
    evs = events()
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        for rec in evs:
            f.write(json.dumps(rec, default=str))
            f.write("\n")
        if reason:
            f.write(json.dumps({"ts": time.time(), "role": _state["role"],
                                "rank": _state["rank"],
                                "event": "flight.dump",
                                "attrs": {"reason": reason}}))
            f.write("\n")
    os.replace(tmp, path)
    return path


_hooks = {"installed": False}


def install_crash_hooks():
    """Dump the ring on unhandled crash and on SIGTERM (chains any
    previously installed handlers).  No-op unless MXTPU_FLIGHT_EXPORT
    is set; SIGTERM hook is skipped off the main thread."""
    if _hooks["installed"] or not dump_path():
        return
    _hooks["installed"] = True

    prev_excepthook = sys.excepthook

    def _flight_excepthook(exc_type, exc, tb):
        record("crash", error=exc_type.__name__, message=str(exc)[:200])
        try:
            dump(reason="excepthook")
        except OSError:
            pass
        prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _flight_excepthook

    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _flight_sigterm(signum, frame):
            record("sigterm")
            try:
                dump(reason="sigterm")
            except OSError:
                pass
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                # restore default disposition and re-deliver so the
                # process still dies with SIGTERM semantics
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _flight_sigterm)
    except (ValueError, OSError):
        pass   # not the main thread / platform without SIGTERM


def _init_from_env():
    if os.environ.get("MXTPU_FLIGHT", "") == "1" or dump_path():
        enable()
        install_crash_hooks()


_init_from_env()
