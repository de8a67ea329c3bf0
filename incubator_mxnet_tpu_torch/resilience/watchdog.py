"""Hang watchdog: per-phase deadlines over the training loop.

Counterpart of ``incubator_mxnet_tpu/resilience/watchdog.py``.

A training job that dies prints a traceback; a training job that HANGS
prints nothing — a stuck dataloader worker, a peer that stopped
answering RPCs, or a wedged device step all look identical from the
outside (no log lines, flat accelerator utilization). The watchdog
makes hangs observable and recoverable:

- code brackets its blocking regions in ``wd.phase("step")`` /
  ``wd.phase("batch_wait")`` / ``wd.phase("rpc")`` context managers;
- a daemon monitor thread checks every live phase against its deadline;
- on expiry it dumps EVERY thread's stack plus a telemetry snapshot
  (every instrument with data) to stderr and an
  optional file, and can optionally SIGTERM the process so the
  CheckpointManager preemption handler runs a final save and the
  launcher restarts into the resume path.

``GuardedTrainer`` brackets its steps in the "step" phase and picks up
``watchdog.current()`` — None until a Watchdog is installed. The
dataloader's and the RPC transport's phases of the JAX package are
ROADMAP Queue 1 item 13. This module imports nothing heavier than
telemetry.
"""

import os
import signal
import sys
import threading
import time
import traceback

__all__ = ["Watchdog", "current", "format_thread_stacks"]

_installed = {"wd": None}


def current():
    """The process-wide installed Watchdog, or None."""
    return _installed["wd"]


def format_thread_stacks():
    """Render every live thread's Python stack (the hang post-mortem)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append("--- thread %s (%s) ---"
                     % (tid, names.get(tid, "?")))
        lines.extend(l.rstrip("\n")
                     for l in traceback.format_stack(frame))
    return "\n".join(lines)


def _env_float(name, default):
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError("%s=%r is not a number" % (name, v))


class Watchdog:
    """Monitor thread enforcing per-phase deadlines.

    Parameters (each falls back to its ``MXTPU_WATCHDOG_*`` env var,
    then the built-in default):

    step_timeout : seconds one guarded/plain train step may take
        (``MXTPU_WATCHDOG_STEP_TIMEOUT``, default 600 — the first step
        includes building the kernels).
    batch_timeout : seconds the consumer may block waiting on the
        dataloader (``MXTPU_WATCHDOG_BATCH_TIMEOUT``, default 300).
    rpc_timeout : seconds one RPC round-trip may take
        (``MXTPU_WATCHDOG_RPC_TIMEOUT``, default 300).
    membership_timeout : seconds a membership refresh / elastic
        bootstrap against the scheduler may take
        (``MXTPU_WATCHDOG_MEMBERSHIP_TIMEOUT``, default 300) — a
        scheduler that wedges mid-membership-change surfaces here
        instead of stalling the worker silently.
    poll : monitor wake period (``MXTPU_WATCHDOG_POLL``, default 1.0).
    sigterm : on expiry, SIGTERM the process after dumping
        (``MXTPU_WATCHDOG_SIGTERM``, default off) — with a
        CheckpointManager preemption handler installed this converts a
        silent hang into a clean save-and-restart.
    dump_path : also append the dump to this file
        (``MXTPU_WATCHDOG_DUMP``; stderr always gets it).
    install : register as the process-wide ``current()`` watchdog so
        a GuardedTrainer built without one picks it up (default True).

    A phase that expires fires ONCE (dump + optional SIGTERM), is
    recorded in ``self.fired``, and keeps counting in the
    ``watchdog_fires`` telemetry counter; the blocked call itself is
    not interrupted (Python offers no safe cross-thread interrupt) —
    recovery is the SIGTERM path or the caller's own timeout.
    """

    _DEFAULTS = {"step": ("MXTPU_WATCHDOG_STEP_TIMEOUT", 600.0),
                 "batch_wait": ("MXTPU_WATCHDOG_BATCH_TIMEOUT", 300.0),
                 "rpc": ("MXTPU_WATCHDOG_RPC_TIMEOUT", 300.0),
                 "membership": ("MXTPU_WATCHDOG_MEMBERSHIP_TIMEOUT", 300.0)}

    def __init__(self, step_timeout=None, batch_timeout=None,
                 rpc_timeout=None, membership_timeout=None,
                 poll=None, sigterm=None, dump_path=None,
                 install=True):
        explicit = {"step": step_timeout, "batch_wait": batch_timeout,
                    "rpc": rpc_timeout, "membership": membership_timeout}
        self._timeouts = {}
        for phase, (env, dflt) in self._DEFAULTS.items():
            t = explicit[phase]
            self._timeouts[phase] = (float(t) if t is not None
                                     else _env_float(env, dflt))
        self._poll = (float(poll) if poll is not None
                      else _env_float("MXTPU_WATCHDOG_POLL", 1.0))
        self._sigterm = (bool(sigterm) if sigterm is not None else
                         os.environ.get("MXTPU_WATCHDOG_SIGTERM", "0")
                         not in ("", "0", "false", "off"))
        self._dump_path = (dump_path if dump_path is not None
                           else os.environ.get("MXTPU_WATCHDOG_DUMP"))
        self._lock = threading.Lock()
        self._entries = {}          # eid -> [phase, deadline, tid, fired]
        self._next_eid = 0
        self.fired = []             # [(phase, thread_name, overdue_s)]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-watchdog")
        self._thread.start()
        if install:
            _installed["wd"] = self

    # ------------------------------------------------------------ phases
    class _Phase:
        __slots__ = ("_wd", "_eid")

        def __init__(self, wd, eid):
            self._wd = wd
            self._eid = eid

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            with self._wd._lock:
                self._wd._entries.pop(self._eid, None)
            return False

        def extend(self):
            """Push this phase's deadline out by its full timeout
            (long-lived phases that make observable progress)."""
            wd = self._wd
            with wd._lock:
                e = wd._entries.get(self._eid)
                if e is not None:
                    e[1] = time.monotonic() + wd._timeouts.get(
                        e[0], 300.0)

        def cancel(self):
            with self._wd._lock:
                self._wd._entries.pop(self._eid, None)

    def phase(self, name, timeout=None):
        """Context manager arming a deadline for the calling thread's
        next blocking region. Cheap: one lock + dict insert."""
        t = timeout if timeout is not None else self._timeouts.get(name)
        if t is None:
            t = 300.0
        with self._lock:
            eid = self._next_eid
            self._next_eid += 1
            self._entries[eid] = [name, time.monotonic() + float(t),
                                  threading.current_thread().name, False]
        return self._Phase(self, eid)

    # ----------------------------------------------------------- monitor
    def _run(self):
        while not self._stop.wait(self._poll):
            now = time.monotonic()
            due = []
            with self._lock:
                for e in self._entries.values():
                    if not e[3] and now > e[1]:
                        e[3] = True           # fire once per phase entry
                        due.append((e[0], e[2], now - e[1]))
            for phase, tname, overdue in due:
                self._fire(phase, tname, overdue)

    def _fire(self, phase, thread_name, overdue):
        self.fired.append((phase, thread_name, overdue))
        from ..telemetry import catalog as _cat
        from ..telemetry import flight as _fl
        _cat.watchdog_fires.inc(phase=phase)
        _fl.record("watchdog.fire", phase=phase, thread=thread_name,
                   overdue_s=round(overdue, 1))
        report = self._render(phase, thread_name, overdue)
        sys.stderr.write(report)
        sys.stderr.flush()
        if self._dump_path:
            try:
                with open(self._dump_path, "a") as f:
                    f.write(report)
            except OSError as e:
                sys.stderr.write("watchdog: cannot write dump %s: %s\n"
                                 % (self._dump_path, e))
        # flight-recorder dump rides along: next to the thread dump when
        # one is configured, else to MXTPU_FLIGHT_EXPORT (no-op if neither)
        try:
            _fl.dump(path=(self._dump_path + ".flight.jsonl")
                     if self._dump_path else None,
                     reason="watchdog:%s" % phase)
        except OSError:
            pass
        if self._sigterm:
            os.kill(os.getpid(), signal.SIGTERM)

    def _render(self, phase, thread_name, overdue):
        lines = ["",
                 "=" * 70,
                 "MXTPU WATCHDOG: phase %r on thread %r exceeded its "
                 "deadline by %.1fs" % (phase, thread_name, overdue),
                 "=" * 70,
                 format_thread_stacks()]
        # telemetry snapshot: every instrument with data
        try:
            from .. import telemetry
            snap = telemetry.snapshot()
            nonzero = {k: v["series"] for k, v in snap.items()
                       if v["series"]}
            lines.append("--- telemetry (%d instruments with data) ---"
                         % len(nonzero))
            for name, series in sorted(nonzero.items()):
                for labels, val in sorted(series.items()):
                    if isinstance(val, dict):
                        val = "count=%s sum=%.6g" % (val["count"],
                                                     val["sum"])
                    lines.append("  %s{%s} = %s" % (name, labels, val))
        except Exception as e:  # noqa: BLE001 — post-mortem must not crash
            lines.append("telemetry snapshot unavailable: %s" % e)
        lines.append("=" * 70)
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------- admin
    def stop(self):
        """Stop the monitor thread and uninstall from current()."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if _installed["wd"] is self:
            _installed["wd"] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
