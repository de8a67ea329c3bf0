"""Last-good rollback ring: bounded device-side state snapshots.

Periodically copies the trainer's full device-resident state
(``ShardedTrainer.device_snapshot``: params + aux + optimizer slots +
step counter) into an in-memory ring. When the guardian sees K
consecutive bad steps it rewinds to the newest ring entry and replays;
repeated rewinds pop progressively OLDER entries (the newest snapshot
may itself have been taken after the numerics went subtly bad), and
when the ring runs dry the guardian falls back to
``CheckpointManager.restore``.

Counterpart of ``incubator_mxnet_tpu/resilience/rollback.py``. Memory:
depth × state size on the device (tensors, never transferred to the
host). depth=2 of a 1-GB state costs 2 GB — size the ring to the model.
A snapshot is cloned on capture and copied into the live tensors on
restore, so one entry can be restored more than once (see
``ShardedTrainer.device_snapshot``).
"""

import os

__all__ = ["RollbackRing"]


def _env_int(name, default):
    v = os.environ.get(name)
    if not v:
        return int(default)
    try:
        return int(v)
    except ValueError:
        raise ValueError("%s=%r is not an integer" % (name, v))


class RollbackRing:
    """Bounded ring of device-state snapshots.

    depth : max snapshots retained (``MXTPU_GUARD_RING_DEPTH``,
        default 2); oldest is dropped when full.
    interval : steps between automatic snapshots via
        ``maybe_snapshot`` (``MXTPU_GUARD_RING_INTERVAL``, default 100).
    """

    def __init__(self, depth=None, interval=None):
        self.depth = depth if depth is not None \
            else _env_int("MXTPU_GUARD_RING_DEPTH", 2)
        self.interval = interval if interval is not None \
            else _env_int("MXTPU_GUARD_RING_INTERVAL", 100)
        if self.depth < 1:
            raise ValueError("ring depth must be >= 1, got %r" % self.depth)
        if self.interval < 1:
            raise ValueError("snapshot interval must be >= 1, got %r"
                             % self.interval)
        self._ring = []          # oldest .. newest
        self._last_step = None

    def __len__(self):
        return len(self._ring)

    def steps(self):
        """Step numbers currently snapshotted, oldest first."""
        return [s["step"] for s in self._ring]

    def snapshot(self, trainer):
        """Capture the trainer's device state now (drops the oldest
        entry when the ring is full)."""
        snap = trainer.device_snapshot()
        self._ring.append(snap)
        if len(self._ring) > self.depth:
            self._ring.pop(0)
        self._last_step = snap["step"]
        from ..telemetry import catalog as _cat
        _cat.rollback_snapshots.inc()

    def maybe_snapshot(self, trainer):
        """Snapshot when `interval` steps passed since the last one.
        Returns True when a snapshot was taken."""
        step = trainer._step_count
        if self._last_step is not None and \
                step - self._last_step < self.interval:
            return False
        self.snapshot(trainer)
        return True

    def rewind(self, trainer):
        """Restore the NEWEST snapshot and POP it — a second rewind goes
        one entry older (the popped snapshot may already carry the rot
        that produced the bad steps). Returns the restored step number,
        or None when the ring is empty (caller falls back to the
        checkpoint manager)."""
        if not self._ring:
            return None
        snap = self._ring.pop()
        trainer.restore_device_snapshot(snap)
        # forget staleness so the next good step re-primes the ring
        self._last_step = None
        return snap["step"]
