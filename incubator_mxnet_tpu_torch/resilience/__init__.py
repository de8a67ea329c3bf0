"""Training resilience: numeric guard, last-good rollback, hang watchdog.

Counterpart of ``incubator_mxnet_tpu/resilience/``, with the same public
names, knobs (``MXTPU_GUARD*``, the ring's ``MXTPU_GUARD_RING_*``,
``MXTPU_WATCHDOG*``) and policy. The unit of
execution is one train step, which either commits or is skipped as a
whole (``ShardedTrainer.step_guarded`` selects on the device):

- ``GuardedTrainer`` (guardian.py) — wraps ShardedTrainer: on-device
  finite-check + skip, dynamic loss scaling, skip budget, rollback
  policy;
- ``NumericGuard`` (guard.py) — host loss-scale automaton;
- ``RollbackRing`` (rollback.py) — bounded device-side snapshot ring;
- ``Watchdog`` (watchdog.py) — per-phase hang deadlines with
  stack/telemetry dumps (the guardian's "step" phase; the dataloader and
  RPC transport hooks are ROADMAP Queue 1 item 13);
- ``TrainingDivergedError`` — the guardian's give-up signal.
"""

from .guard import NumericGuard, TrainingDivergedError
from .guardian import GuardedTrainer
from .rollback import RollbackRing
from .watchdog import Watchdog, current, format_thread_stacks

__all__ = ["GuardedTrainer", "NumericGuard", "RollbackRing", "Watchdog",
           "TrainingDivergedError", "current", "format_thread_stacks"]
