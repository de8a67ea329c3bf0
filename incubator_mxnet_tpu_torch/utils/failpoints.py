"""Named failpoints for deterministic fault injection.

Counterpart of ``incubator_mxnet_tpu/utils/failpoints.py``, with the same
spec and semantics. A failpoint is a named site threaded through the
transport (``kvstore/rpc.py``):

    from incubator_mxnet_tpu_torch.utils import failpoints
    if failpoints.failpoint("rpc.send.drop"):
        raise OSError("injected")

``failpoint(name)`` returns a falsy value when the site is inactive and the
site's configured ``value`` (default ``True``) when it fires; the SITE
decides what firing means (drop a frame, sleep). The check is a single
module-dict truthiness test when no failpoint is active anywhere.

Activation:

- programmatic: ``activate("rpc.send.drop", prob=1.0, count=2)`` /
  ``deactivate(name)`` / ``reset()``, or the ``active(...)`` context
  manager which restores the previous state on exit;
- environment: ``MXTPU_FAILPOINTS=name[:prob[:count[:value]]],...`` parsed
  at import (subprocesses inherit it). ``prob`` is the firing probability
  (default 1), ``count`` the number of times the site may fire before
  deactivating itself (default unlimited), ``value`` what the site receives
  when it fires (float if it parses, else the raw string). The value
  ``sleep=SECONDS`` hangs the firing thread inside ``failpoint()`` itself
  and returns False to the site: any site becomes an injectable hang, e.g.
  ``MXTPU_FAILPOINTS=rpc.reply.drop:1:1:sleep=5``.

Sites in the port (grep for ``failpoint(`` to enumerate):

- ``rpc.send.drop``   - Connection.call: fail before the request frame is
  written (the request is never applied).
- ``rpc.recv.drop``   - Connection.call: fail after the request frame is
  written (the request IS applied; the reply is lost).
- ``rpc.reply.delay`` - rpc.Server: sleep ``value`` seconds before writing
  the reply.
- ``rpc.reply.drop``  - rpc.Server: apply the request, drop the connection
  instead of replying.
"""

import os
import random
import threading
import time

__all__ = ["failpoint", "activate", "deactivate", "reset", "active",
           "is_active", "load_env", "list_active"]

_lock = threading.Lock()
# name -> [prob, remaining_count_or_None, value]; the module-level dict
# doubles as the fast-path gate: `if not _ACTIVE` costs one dict check.
_ACTIVE = {}


def failpoint(name):
    """Return falsy when inactive; the configured value when firing.

    A ``sleep=SECONDS`` value is special: the firing thread sleeps HERE
    (outside the registry lock, so concurrent failpoint checks never
    stall behind an injected hang) and the site sees False — any
    instrumented site doubles as a pure hang point for watchdog drills,
    with no per-site sleep handling."""
    if not _ACTIVE:
        return False
    with _lock:
        fp = _ACTIVE.get(name)
        if fp is None:
            return False
        prob, count, value = fp
        if prob < 1.0 and random.random() >= prob:
            return False
        if count is not None:
            if count <= 0:
                return False
            fp[1] = count - 1
            if fp[1] <= 0:
                del _ACTIVE[name]
    # import here, not at module top: firing is rare, and the inactive
    # fast path above must stay one dict check
    from ..telemetry import catalog as _cat
    _cat.failpoints_triggered.inc(name=name)
    if isinstance(value, str) and value.startswith("sleep="):
        time.sleep(float(value[len("sleep="):]))
        return False
    return value


def activate(name, prob=1.0, count=None, value=True):
    """Arm `name`: fire with probability `prob`, at most `count` times
    (None = unlimited), handing `value` to the site. A string value of
    ``sleep=SECONDS`` makes the firing itself sleep and the site see
    False (injectable hang; validated here so a typo fails at arm time,
    not silently mid-chaos-run)."""
    if isinstance(value, str) and value.startswith("sleep="):
        try:
            float(value[len("sleep="):])
        except ValueError:
            raise ValueError("bad sleep failpoint value %r "
                             "(want sleep=SECONDS)" % value)
    with _lock:
        _ACTIVE[name] = [float(prob), count, value]


def deactivate(name):
    with _lock:
        _ACTIVE.pop(name, None)


def reset():
    """Disarm every failpoint (returns the module to zero-overhead)."""
    with _lock:
        _ACTIVE.clear()


def is_active(name):
    return name in _ACTIVE


def list_active():
    with _lock:
        return {k: tuple(v) for k, v in _ACTIVE.items()}


class active:
    """Context manager: arm on enter, restore the prior state on exit."""

    def __init__(self, name, prob=1.0, count=None, value=True):
        self._args = (name, prob, count, value)
        self._prev = None

    def __enter__(self):
        name = self._args[0]
        with _lock:
            self._prev = _ACTIVE.get(name)
        activate(*self._args)
        return self

    def __exit__(self, *exc):
        name = self._args[0]
        with _lock:
            if self._prev is None:
                _ACTIVE.pop(name, None)
            else:
                _ACTIVE[name] = self._prev
        return False


def load_env(spec=None):
    """Parse ``MXTPU_FAILPOINTS=name[:prob[:count[:value]]],...`` (or an
    explicit `spec` string) and arm the listed failpoints. Malformed
    entries raise ValueError — silently ignoring a typo'd failpoint would
    make a chaos run silently fault-free."""
    if spec is None:
        spec = os.environ.get("MXTPU_FAILPOINTS", "")
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        parts = entry.split(":")
        name = parts[0]
        if not name:
            raise ValueError("MXTPU_FAILPOINTS entry with empty name: %r"
                             % entry)
        try:
            prob = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            count = (int(parts[2]) if len(parts) > 2 and parts[2]
                     else None)
        except ValueError:
            raise ValueError("bad MXTPU_FAILPOINTS entry %r "
                             "(want name[:prob[:count[:value]]])" % entry)
        value = True
        if len(parts) > 3 and parts[3]:
            try:
                value = float(parts[3])
            except ValueError:
                value = parts[3]
        activate(name, prob=prob, count=count, value=value)


load_env()
