"""Runtime lockdep witness: lock-order and blocking-under-lock checks.

Counterpart of ``incubator_mxnet_tpu/telemetry/lockdep.py``. It witnesses
two invariants on the live process, Linux lockdep-style:

- ``MXTPU_LOCKDEP=1`` patches ``threading.Lock``/``threading.RLock``
  (``Condition`` composes on top of them) with thin proxies that keep a
  per-thread stack of held locks and accumulate the observed process-wide
  lock-order graph. Locks are grouped into *classes* by construction site
  (file:line), so two connections' locks are one class and an A->B order
  in one place collides with a later B->A order elsewhere.
- On a NEW graph edge the witness checks for a cycle; an inversion emits a
  ``lockdep.violation`` flight event, bumps
  ``mxtpu_lockdep_violations_total{kind="order"}``, and records a report of
  both sides: the stack that established each edge of the cycle plus the
  acquiring thread's current stack.
- ``check_blocking(desc)``, called from the blocking chokepoints (rpc
  ``send_msg``/``recv_msg``) and from the patched ``time.sleep``, fires
  ``kind="blocking"`` when any non-exempt lock is held across the blocking
  operation, with the holder's acquire stacks. In the port this covers the
  CUDA graph capture lock of ``compilecache/aot.py``, which is held across a
  device round trip: no rpc send or receive may run under it.
- ``MXTPU_LOCKDEP_FATAL=1`` escalates any violation to a RuntimeError in
  the offending thread.

``allow_blocking(lock)`` exempts a lock whose purpose is to serialize a
blocking section (the rpc connection lock).

Off path: ``enabled()``/``check_blocking()`` are one dict lookup when
``MXTPU_LOCKDEP`` is unset. Nothing is patched until ``install()`` runs,
and that happens at import only when the env var is set; the port's
package imports this module before any other, so its own locks are
witnessed. Locks created before ``install()`` are invisible; same-class
nesting (two instances from one constructor site) is skipped.
"""

import os
import sys
import threading
import time

__all__ = ["enabled", "fatal", "install", "uninstall", "installed",
           "check_blocking", "allow_blocking", "report", "violations",
           "reset", "statusz_entry", "format_violation"]

_state = {"enabled": False, "fatal": False, "installed": False}

# originals captured at import time (before any install) — the witness's
# own bookkeeping must never run through its own proxies
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_SLEEP = time.sleep

_MAX_VIOLATIONS = 256
_MAX_STACK = 16

_graph_lock = _ORIG_LOCK()
_graph = {}          # (a_class, b_class) -> edge dict (first sighting)
_classes = {}        # class key "file:line" -> {"kind", "instances"}
_violations = []     # bounded list of violation dicts
_seen = set()        # dedup keys so one bad pattern reports once

_tls = threading.local()


def enabled():
    return _state["enabled"]


def fatal():
    return _state["fatal"]


def installed():
    return _state["installed"]


def _tstate():
    st = getattr(_tls, "st", None)
    if st is None:
        st = _tls.st = _ThreadState()
    return st


class _ThreadState:
    __slots__ = ("held", "reent")

    def __init__(self):
        self.held = []        # [_Held] in acquisition order
        self.reent = False    # True while the witness itself is working


class _Held:
    __slots__ = ("obj", "stack", "count")

    def __init__(self, obj, stack):
        self.obj = obj
        self.stack = stack
        self.count = 1


_SKIP_FILES = (os.sep + "threading.py", os.sep + "lockdep.py")


def _stack(skip=1):
    """Cheap formatted stack: newest frame first, witness/threading
    internals skipped so a Condition's inner RLock blames the caller."""
    out = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return out
    while f is not None and len(out) < _MAX_STACK:
        fn = f.f_code.co_filename
        if not fn.endswith(_SKIP_FILES):
            out.append("%s:%d in %s" % (fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return out


def _site(skip=1):
    """Construction site 'file:line' — the lock's CLASS identity."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "<unknown>"
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(_SKIP_FILES):
            return "%s:%d" % (fn, f.f_lineno)
        f = f.f_back
    return "<unknown>"


# ---------------------------------------------------------------------------
# proxies
# ---------------------------------------------------------------------------

class _ProxyBase:
    __slots__ = ("_inner", "_key", "_allow_blocking")

    def __init__(self, inner, kind):
        self._inner = inner
        self._key = _site(skip=3)
        self._allow_blocking = False
        with _graph_lock:
            c = _classes.setdefault(self._key,
                                    {"kind": kind, "instances": 0})
            c["instances"] += 1

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        _note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # stdlib consumers (concurrent.futures, threading internals)
        # reinit locks in fork children through this hook
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<lockdep %s %s>" % (type(self).__name__, self._key)


class _LockProxy(_ProxyBase):
    """threading.Lock stand-in.  Condition uses the release()/acquire()
    fallback protocol against it (no _release_save on plain locks), so
    wait() bookkeeping rides the normal methods."""
    __slots__ = ()


class _RLockProxy(_ProxyBase):
    """threading.RLock stand-in.  Implements the Condition protocol
    (_release_save/_acquire_restore/_is_owned) by delegating to the
    inner RLock while keeping the held-stack honest: wait() fully
    releases the lock, however deep the reentrancy."""
    __slots__ = ()

    def _release_save(self):
        state = self._inner._release_save()
        _note_release_all(self)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        _note_acquire(self)

    def _is_owned(self):
        return self._inner._is_owned()


def _make_lock():
    return _LockProxy(_ORIG_LOCK(), "Lock")


def _make_rlock():
    return _RLockProxy(_ORIG_RLOCK(), "RLock")


def allow_blocking(lock):
    """Mark a lock as intentionally-held-across-blocking (its purpose is
    to serialize a blocking section — e.g. the rpc connection lock that
    IS the one-outstanding-request wire protocol).  No-op on raw locks
    (witness not installed)."""
    if isinstance(lock, _ProxyBase):
        lock._allow_blocking = True
    return lock


# ---------------------------------------------------------------------------
# bookkeeping
# ---------------------------------------------------------------------------

def _note_acquire(proxy):
    st = _tstate()
    if st.reent:
        return
    for h in st.held:
        if h.obj is proxy:
            h.count += 1      # reentrant re-acquire: no new edges
            return
    st.reent = True
    try:
        stack = _stack(skip=2)
        new_edges = []
        with _graph_lock:
            for h in st.held:
                a, b = h.obj._key, proxy._key
                if a == b:
                    continue  # same-class nesting: out of scope (see doc)
                e = _graph.get((a, b))
                if e is not None:
                    e["count"] += 1
                    continue
                _graph[(a, b)] = {
                    "count": 1, "thread": threading.current_thread().name,
                    "holder_stack": list(h.stack),
                    "acquirer_stack": list(stack)}
                new_edges.append((a, b))
            cycles = [(edge, _find_path(edge[1], edge[0]))
                      for edge in new_edges]
        for edge, path in cycles:
            if path:
                _report_order(edge, path)
    finally:
        st.reent = False
    st.held.append(_Held(proxy, stack))


def _note_release(proxy):
    st = _tstate()
    if st.reent:
        return
    held = st.held
    for i in range(len(held) - 1, -1, -1):
        if held[i].obj is proxy:
            held[i].count -= 1
            if held[i].count == 0:
                del held[i]
            return


def _note_release_all(proxy):
    st = _tstate()
    if st.reent:
        return
    st.held = [h for h in st.held if h.obj is not proxy]


def _find_path(src, dst):
    """Edge path src ->* dst over the observed order graph (caller holds
    _graph_lock).  Returns the edge list or None."""
    g = {}
    for (a, b) in _graph:
        g.setdefault(a, []).append(b)
    stack = [(src, [])]
    visited = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in visited or len(path) > 8:
            continue
        visited.add(node)
        for nxt in g.get(node, ()):
            stack.append((nxt, path + [(node, nxt)]))
    return None


# ---------------------------------------------------------------------------
# violations
# ---------------------------------------------------------------------------

def check_blocking(desc="blocking"):
    """Called at known blocking chokepoints: fires a ``blocking``
    violation when any non-exempt lock is held.  One dict lookup when
    the witness is off."""
    if not _state["enabled"]:
        return
    st = _tstate()
    if st.reent:
        return
    offenders = [h for h in st.held if not h.obj._allow_blocking]
    if not offenders:
        return
    st.reent = True
    try:
        here = _stack(skip=2)
        site = here[0] if here else "<unknown>"
        key = ("blocking", desc, site,
               tuple(h.obj._key for h in offenders))
        with _graph_lock:
            if key in _seen:
                return
            _seen.add(key)
        _emit({
            "kind": "blocking",
            "desc": desc,
            "thread": threading.current_thread().name,
            "locks": [h.obj._key for h in offenders],
            "blocking_stack": here,
            "holder_stacks": {h.obj._key: list(h.stack)
                              for h in offenders},
        })
    finally:
        st.reent = False


def _report_order(edge, path):
    """A new edge (a, b) closed a cycle b ->* a.  Caller is the thread
    that just acquired b while holding a; the path edges carry the
    first-sighting stacks of the other side(s)."""
    a, b = edge
    cycle = [edge] + path
    key = ("order", frozenset(cycle))
    with _graph_lock:
        if key in _seen:
            return
        _seen.add(key)
        sides = {}
        for (x, y) in cycle:
            e = _graph.get((x, y), {})
            sides["%s -> %s" % (x, y)] = {
                "thread": e.get("thread"),
                "holder_stack": e.get("holder_stack", []),
                "acquirer_stack": e.get("acquirer_stack", [])}
    _emit({
        "kind": "order",
        "thread": threading.current_thread().name,
        "cycle": ["%s -> %s" % (x, y) for (x, y) in cycle],
        "locks": sorted({x for e in cycle for x in e}),
        "sides": sides,
    })


def _emit(v):
    v["ts"] = time.time()
    with _graph_lock:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(v)
    # flight + counter ride the lazy-import idiom every producer uses
    from . import flight as _fl
    _fl.record("lockdep.violation", kind=v["kind"],
               locks=",".join(v.get("locks", [])),
               thread=v.get("thread"))
    from . import catalog as _cat
    _cat.lockdep_violations.inc(kind=v["kind"])
    if _state["fatal"]:
        raise RuntimeError("lockdep violation (MXTPU_LOCKDEP_FATAL=1):\n"
                           + format_violation(v))


def format_violation(v):
    """Human-readable both-sides report for one violation."""
    lines = ["kind=%s thread=%s locks=%s"
             % (v["kind"], v.get("thread"),
                ", ".join(v.get("locks", [])))]
    if v["kind"] == "order":
        lines.append("cycle: " + "  =>  ".join(v.get("cycle", [])))
        for edge, side in sorted(v.get("sides", {}).items()):
            lines.append("  edge %s (first seen in thread %s)"
                         % (edge, side.get("thread")))
            lines.append("    holder stack:")
            lines += ["      " + s for s in side.get("holder_stack", [])]
            lines.append("    acquirer stack:")
            lines += ["      " + s for s in side.get("acquirer_stack", [])]
    else:
        lines.append("blocking op: %s" % v.get("desc"))
        lines.append("  blocking stack:")
        lines += ["    " + s for s in v.get("blocking_stack", [])]
        for lk, stk in sorted(v.get("holder_stacks", {}).items()):
            lines.append("  held %s acquired at:" % lk)
            lines += ["    " + s for s in stk]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# lifecycle + reporting
# ---------------------------------------------------------------------------

def install():
    """Patch the lock constructors (+ time.sleep) and start witnessing.
    Idempotent."""
    if _state["installed"]:
        _state["enabled"] = True
        return
    threading.Lock = _make_lock
    threading.RLock = _make_rlock

    def _sleep(secs):
        check_blocking("time.sleep")
        _ORIG_SLEEP(secs)

    time.sleep = _sleep
    _state["installed"] = True
    _state["enabled"] = True


def uninstall():
    """Restore the original constructors.  Existing proxy locks keep
    working (they wrap real locks); they just stop being witnessed."""
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    time.sleep = _ORIG_SLEEP
    _state["installed"] = False
    _state["enabled"] = False


def reset():
    """Drop accumulated graph/violations (tests); keeps installation."""
    with _graph_lock:
        _graph.clear()
        _classes.clear()
        _violations.clear()
        _seen.clear()


def violations():
    with _graph_lock:
        return [dict(v) for v in _violations]


def report():
    """Full witness state — the drills ship this across the process
    boundary to assert zero violations."""
    if not _state["enabled"]:
        return {"enabled": False}
    with _graph_lock:
        return {
            "enabled": True,
            "fatal": _state["fatal"],
            "classes": len(_classes),
            "edges": len(_graph),
            "violations": [dict(v) for v in _violations],
        }


def statusz_entry():
    """Constant stub when off; counts (not full stacks) when on."""
    if not _state["enabled"]:
        return {"enabled": False}
    with _graph_lock:
        return {"enabled": True, "fatal": _state["fatal"],
                "classes": len(_classes), "edges": len(_graph),
                "violations": len(_violations)}


def _init_from_env():
    if os.environ.get("MXTPU_LOCKDEP", "") not in ("", "0"):
        _state["fatal"] = os.environ.get(
            "MXTPU_LOCKDEP_FATAL", "") not in ("", "0")
        install()


_init_from_env()
