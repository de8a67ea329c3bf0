"""Profiler: scoped config, chrome-trace dump, aggregate stats.

Counterpart of ``incubator_mxnet_tpu/profiler.py`` (reference parity:
src/profiler/profiler.h and python/mxnet/profiler.py: set_config, start /
stop scopes, custom Task/Frame/Event/Counter/Marker, dumps()). A host-side
event recorder emits the reference's chrome://tracing JSON and an aggregate
table; the trace spans of ``telemetry.tracing`` land in it while it runs.

The device timeline: with ``set_config(use_xplane=True)`` (the JAX
package's knob name), ``start()`` also runs ``torch.profiler`` with the CUDA
activity where the card is present, and ``stop()`` writes its chrome trace
to ``xplane_dir`` (default ``torch-trace``) as ``device_trace.json``. The
card's tracer can lose device events late in a long run, so ``stop()``
counts what it kept: ``device_trace()`` returns the kernel launches the
host issued, the kernel events the trace holds, and whether the two agree.
A trace with fewer kernel events than launches is marked ``complete:
False``; where CUDA graphs were replayed inside the window (one launch, many
kernels) the count cannot tell and ``complete`` is None.
"""

import atexit
import json
import threading
import time

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "Task", "Frame", "Event", "Counter", "Marker", "scope",
           "device_trace"]

_config = {"filename": "profile.json", "aggregate_stats": False,
           "profile_all": False, "profile_symbolic": True,
           "profile_imperative": True, "profile_memory": False,
           "profile_api": False, "continuous_dump": False}
_state = {"running": False, "device_prof": None,
          "device_trace": None}
_events = []
_lock = threading.Lock()


# -- PS server-side profiling (reference: include/mxnet/kvstore.h:385
# SetServerProfilerCommand). Profiler calls with profile_process="server"
# route through a registered dist kvstore to every server process. The
# port has no dist kvstore yet, so they raise, as they do in the JAX
# package without one.
_kvstore_handle = None


def set_kvstore_handle(kv):
    """Register the kvstore the server-profiling commands ride on
    (reference: profiler.set_kvstore_handle, called by kv.create)."""
    global _kvstore_handle
    _kvstore_handle = kv


def _server_cmd(action, params=None):
    if _kvstore_handle is None or not getattr(_kvstore_handle, "is_dist",
                                              False):
        raise RuntimeError(
            "profile_process='server' requires a dist kvstore "
            "(created before the profiler call, or registered via "
            "profiler.set_kvstore_handle)")
    return _kvstore_handle._server_profiler_command(action, params or {})


def set_config(**kwargs):
    if kwargs.pop("profile_process", "worker") == "server":
        _server_cmd("set_config", kwargs)
        return
    _config.update(kwargs)


def start(profile_process="worker"):
    if profile_process == "server":
        _server_cmd("state", {"state": "run"})
        return
    _state["running"] = True
    _events.clear()
    if _config.get("use_xplane"):
        _start_device_trace()
    _record("profiler", "start")


def stop(profile_process="worker"):
    if profile_process == "server":
        _server_cmd("state", {"state": "stop"})
        return
    _record("profiler", "stop")
    _state["running"] = False
    if _state["device_prof"] is not None:
        _stop_device_trace()


# -- device timeline (torch.profiler) ------------------------------------
_LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


def _start_device_trace():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _state["device_prof"] = prof
    _state["device_trace"] = None


def _stop_device_trace():
    """Close the torch.profiler window, write its chrome trace and count
    what it kept (see the module docstring)."""
    import os
    import torch
    prof, _state["device_prof"] = _state["device_prof"], None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    launches = graph_launches = kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name in _LAUNCH_NAMES:
            launches += 1
        elif e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch")):
            graph_launches += 1
    out_dir = _config.get("xplane_dir", "torch-trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "device_trace.json")
    prof.export_chrome_trace(path)
    info = {"path": path, "kernel_launches": launches,
            "graph_launches": graph_launches, "kernel_events": kernels,
            "lost": max(0, launches - kernels) if not graph_launches
            else None,
            "complete": (kernels >= launches) if not graph_launches
            else None}
    _state["device_trace"] = info
    return info


def device_trace():
    """What the last device window kept: {"path", "kernel_launches",
    "graph_launches", "kernel_events", "lost", "complete"}, or None when no
    device window ran."""
    return _state["device_trace"]


def pause(profile_process="worker"):
    if profile_process == "server":
        _server_cmd("pause")
        return
    _state["running"] = False


def resume(profile_process="worker"):
    if profile_process == "server":
        _server_cmd("resume")
        return
    _state["running"] = True


def _record(category, name, ph="i", ts=None, dur=None, args=None):
    if not _state["running"] and name not in ("start", "stop"):
        return
    ev = {"cat": category, "name": name, "ph": ph, "pid": 0,
          "tid": threading.get_ident() % 100000,
          "ts": (ts if ts is not None else time.time() * 1e6)}
    if dur is not None:
        ev["dur"] = dur
        ev["ph"] = "X"
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def dump(finished=True, profile_process="worker"):
    """Write the chrome trace. finished=True (the default) also stops
    recording, matching the reference's dump(finished) contract; pass
    finished=False to keep profiling across dumps (continuous dump).
    profile_process='server': every server dumps ITS trace server-side
    AND ships it back — this worker writes each as
    <filename base>_server<i>.json and returns the paths."""
    if profile_process == "server":
        import os
        replies = _server_cmd("dump")
        base, ext = os.path.splitext(_config["filename"])
        paths = []
        for i, (meta, trace) in enumerate(replies):
            p = "%s_server%d%s" % (base, i, ext or ".json")
            with open(p, "wb") as f:
                f.write(trace)
            paths.append(p)
        return paths
    with _lock:
        data = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(_config["filename"], "w") as f:
        json.dump(data, f)
    if finished:
        _state["running"] = False


_SORT_KEYS = ("total", "count", "min", "max", "avg", "name")


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate stats (reference: aggregate_stats.cc dump).

    sort_by: one of total|count|min|max|avg|name; ascending flips the
    order. format: "table" (aligned text) or "json" (name -> stats)."""
    if sort_by not in _SORT_KEYS:
        raise ValueError("sort_by must be one of %s, got %r"
                         % ("|".join(_SORT_KEYS), sort_by))
    if format not in ("table", "json"):
        raise ValueError("format must be 'table' or 'json', got %r" % format)
    with _lock:
        evs = [e for e in _events if e.get("ph") == "X"]
    agg = {}
    for e in evs:
        name = e["name"]
        st = agg.setdefault(name, {"count": 0, "total": 0.0, "min": 1e30, "max": 0.0})
        st["count"] += 1
        st["total"] += e["dur"]
        st["min"] = min(st["min"], e["dur"])
        st["max"] = max(st["max"], e["dur"])
    for st in agg.values():
        st["avg"] = st["total"] / st["count"]
    if sort_by == "name":
        items = sorted(agg.items(), reverse=not ascending)
    else:
        items = sorted(agg.items(), key=lambda kv: kv[1][sort_by],
                       reverse=not ascending)
    if reset:
        with _lock:
            _events.clear()
    if format == "json":
        return json.dumps(dict(items), sort_keys=False)
    lines = ["%-40s %8s %12s %12s %12s %12s" % ("Name", "Count",
                                                "Total(us)", "Min(us)",
                                                "Max(us)", "Avg(us)")]
    for name, st in items:
        lines.append("%-40s %8d %12.1f %12.1f %12.1f %12.1f" % (
            name, st["count"], st["total"], st["min"], st["max"],
            st["avg"]))
    return "\n".join(lines)


class _Scoped:
    _category = "event"

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.time() * 1e6

    def stop(self):
        if self._t0 is not None:
            _record(self._category, self.name, ts=self._t0,
                    dur=time.time() * 1e6 - self._t0)
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Task(_Scoped):
    _category = "task"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Frame(_Scoped):
    _category = "frame"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Event(_Scoped):
    _category = "event"


class Counter:
    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value
        self._lock = threading.Lock()

    def set_value(self, value):
        with self._lock:
            self.value = value
        _record("counter", self.name, ph="C", args={"value": value})

    def increment(self, delta=1):
        with self._lock:
            self.value += delta
            value = self.value
        _record("counter", self.name, ph="C", args={"value": value})

    def decrement(self, delta=1):
        with self._lock:
            self.value -= delta
            value = self.value
        _record("counter", self.name, ph="C", args={"value": value})

    __iadd__ = lambda self, d: (self.increment(d), self)[1]
    __isub__ = lambda self, d: (self.decrement(d), self)[1]


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        _record("marker", self.name, ph="i")


def scope(name):
    """Annotate work with a named range in the device timeline
    (``torch.profiler.record_function``)."""
    import torch
    return torch.profiler.record_function(name)


atexit.register(lambda: dump() if _events and _config.get("continuous_dump") else None)


def record_op(name):
    """Context manager used by the NDArray dispatch path to record one op
    event (reference: OprBlock::opr_profile start/stop from the engine,
    src/engine/threaded_engine.h:84). Cheap no-op when not profiling."""
    return _OpScope(name)


class _OpScope:
    __slots__ = ("name", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *a):
        if _state["running"] and (_config.get("profile_all")
                                  or _config.get("profile_imperative")):
            t1 = time.time()
            _record("operator", self.name, ts=self._t0 * 1e6,
                    dur=(t1 - self._t0) * 1e6)


def is_profiling_ops():
    """Fast gate for the dispatch hot path."""
    return _state["running"] and (_config.get("profile_all")
                                  or _config.get("profile_imperative"))
