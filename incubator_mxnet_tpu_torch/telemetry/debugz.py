"""Per-process /debugz introspection HTTP server (stdlib-only).

Counterpart of ``incubator_mxnet_tpu/telemetry/debugz.py``. A serving
process (``serving.ModelServer``) can expose a tiny threaded HTTP server
for live debugging: no dependencies, daemon threads only, loopback by
default:

    /           index of endpoints
    /metrics    Prometheus text exposition of the local registry
    /metrics.json  the same registry as JSON
    /statusz    role, rank, pid, uptime, argv, registered status entries
                (loaded models, generations, ...) and the CUDA devices when
                this process already holds a CUDA context
    /tracez     recent finished spans (tracing's bounded ring);
                ``?trace_id=`` returns that trace's stitched journey
                timeline (``&format=text`` renders the tree)
    /threadz    all-thread stack dump
    /flightz    flight-recorder ring contents
    /alertz     the health plane, which the port does not have yet: it
                answers 501 and says so
    /memz       device-memory plane: per-device allocator bytes, host RSS,
                watermarks, per-program footprints and the KV census
                (JSON; ``?format=text`` renders the human screen)

A page never creates a CUDA context and never synchronizes the card: the
device readers report only when ``torch.cuda.is_initialized()``.

Opt-in via ``MXTPU_DEBUGZ_PORT`` (0 = auto-bind a free port; the bound
address is printed to stderr): ``start_from_env()`` is a no-op when the
variable is unset, and ``set_status()`` is one predicate check while no
server is running.
"""

import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["start", "start_from_env", "stop", "active", "port", "addr",
           "set_identity", "set_status", "status_dict"]

_state = {"server": None, "thread": None, "role": None, "rank": None,
          "start_ts": time.time()}
_status = {}
_lock = threading.Lock()


def active():
    return _state["server"] is not None


def set_identity(role=None, rank=None):
    if role is not None:
        _state["role"] = role
    if rank is not None:
        _state["rank"] = rank


def set_status(key, value):
    """Register a /statusz entry (value or zero-arg callable, evaluated
    per request).  One predicate check while no server is running."""
    if _state["server"] is None:
        return
    with _lock:
        _status[key] = value


def status_dict():
    out = {"role": _state["role"], "rank": _state["rank"],
           "pid": os.getpid(), "argv": sys.argv,
           "uptime_s": round(time.time() - _state["start_ts"], 3)}
    from . import metrics as _m
    out["telemetry_enabled"] = _m.enabled()
    from . import lockdep as _lockdep
    out["lockdep"] = _lockdep.statusz_entry()
    from . import memz as _memz
    out["memz"] = _memz.statusz_entry()
    with _lock:
        entries = list(_status.items())
    for key, value in entries:
        try:
            out[key] = value() if callable(value) else value
        except Exception as exc:           # a bad getter must not 500 statusz
            out[key] = "unavailable: %s" % exc
    # the CUDA devices, only where this process already holds a context:
    # a status page must never create one
    try:
        ident = _memz.device_identity()
    except Exception:  # noqa: BLE001 — statusz must render even when the backend is mid-teardown
        ident = None
    if ident is not None:
        out["cuda_devices"] = ["cuda:%d" % i
                               for i in range(ident["device_count"])]
        out["device_identity"] = ident
    return out


def _thread_stacks():
    """Every live thread's name, id and current stack."""
    frames = sys._current_frames()
    lines = []
    for t in threading.enumerate():
        lines.append("Thread %s (ident=%s, daemon=%s):"
                     % (t.name, t.ident, t.daemon))
        frame = frames.get(t.ident)
        if frame is not None:
            lines += [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
        lines.append("")
    return "\n".join(lines) + "\n"


def _index():
    lines = ["mxtpu debugz (role=%s rank=%s pid=%d)" %
             (_state["role"], _state["rank"], os.getpid()), ""]
    lines += ["/metrics", "/metrics.json", "/statusz", "/tracez",
              "/threadz", "/flightz", "/alertz", "/memz", ""]
    return "\n".join(lines)


class _Handler(BaseHTTPRequestHandler):

    def log_message(self, fmt, *args):     # keep stderr quiet
        pass

    def _reply(self, status, body, ctype):
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        status = 200
        try:
            if path == "/":
                body, ctype = _index(), "text/plain; charset=utf-8"
            elif path == "/metrics":
                from . import export
                body = export.render_prometheus()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                from . import export
                body, ctype = export.render_json(), "application/json"
            elif path == "/statusz":
                body = json.dumps(status_dict(), indent=2, default=str)
                ctype = "application/json"
            elif path == "/tracez":
                from . import tracing
                query = self.path.partition("?")[2]
                params = dict(p.split("=", 1) for p in query.split("&")
                              if "=" in p)
                tid = params.get("trace_id")
                if tid:
                    # journey lookup: the stitched timeline for one
                    # trace id (exemplars in /metrics.json and flight
                    # events in /flightz carry the ids to ask with)
                    tl = tracing.build_timeline(tracing.recent_spans(),
                                                trace_id=tid)
                    if "format=text" in query:
                        body = tracing.render_timeline(tl) + "\n"
                        ctype = "text/plain; charset=utf-8"
                    else:
                        body = json.dumps({"trace_id": tid,
                                           "timeline": tl},
                                          indent=2, default=str)
                        ctype = "application/json"
                else:
                    body = json.dumps({"spans": tracing.recent_spans()},
                                      indent=2, default=str)
                    ctype = "application/json"
            elif path == "/threadz":
                body, ctype = _thread_stacks(), "text/plain; charset=utf-8"
            elif path == "/flightz":
                from . import flight
                body = json.dumps({"enabled": flight.enabled(),
                                   "events": flight.events()},
                                  indent=2, default=str)
                ctype = "application/json"
            elif path == "/alertz":
                # the health plane (telemetry/health.py of the JAX
                # package) is not ported yet
                status, ctype = 501, "text/plain; charset=utf-8"
                body = ("alertz: the health plane is not ported to the "
                        "PyTorch package yet\n")
            elif path == "/memz":
                from . import memz
                query = self.path.partition("?")[2]
                if "format=text" in query:
                    body = memz.render_text()
                    ctype = "text/plain; charset=utf-8"
                else:
                    body = json.dumps(memz.memz_dict(), indent=2,
                                      default=str)
                    ctype = "application/json"
            else:
                status, body, ctype = 404, "not found: %s\n" % path, "text/plain"
        except Exception:  # noqa: BLE001 — the traceback IS the 500 body; a debug endpoint never kills its server
            status, ctype = 500, "text/plain"
            body = "debugz handler error:\n%s" % traceback.format_exc()
        from . import metrics as _m
        if _m._state["enabled"]:
            from . import catalog as _cat
            _cat.debugz_requests.inc(path=path, status=str(status))
        try:
            self._reply(status, body, ctype)
        except OSError:
            pass                           # client went away mid-reply


def start(port_=None, host=None):
    """Start the server (idempotent); returns the ThreadingHTTPServer."""
    with _lock:
        if _state["server"] is not None:
            return _state["server"]
        if port_ is None:
            port_ = int(os.environ.get("MXTPU_DEBUGZ_PORT", "0"))
        host = host or os.environ.get("MXTPU_DEBUGZ_HOST", "127.0.0.1")
        srv = ThreadingHTTPServer((host, int(port_)), _Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever, name="mxtpu-debugz",
                             daemon=True)
        t.start()
        _state["server"], _state["thread"] = srv, t
    sys.stderr.write("mxtpu debugz: http://%s:%d/ (role=%s rank=%s pid=%d)\n"
                     % (host, srv.server_address[1], _state["role"],
                        _state["rank"], os.getpid()))
    return srv


def start_from_env(role=None, rank=None):
    """Start iff MXTPU_DEBUGZ_PORT is set (0 = auto); returns the server
    or None."""
    if os.environ.get("MXTPU_DEBUGZ_PORT") is None:
        return None
    set_identity(role, rank)
    return start()


def port():
    srv = _state["server"]
    return srv.server_address[1] if srv is not None else None


def addr():
    srv = _state["server"]
    return srv.server_address if srv is not None else None


def stop():
    with _lock:
        srv, t = _state["server"], _state["thread"]
        _state["server"] = _state["thread"] = None
        _status.clear()
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=5)
