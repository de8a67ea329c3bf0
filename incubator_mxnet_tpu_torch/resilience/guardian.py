"""Training guardian: the policy loop tying guard + ring + watchdog
together around a ShardedTrainer.

Counterpart of ``incubator_mxnet_tpu/resilience/guardian.py``; the
checkpoint fallback goes through the port's ``utils.CheckpointManager``.

    trainer = ShardedTrainer(block, loss, optimizer="adam")
    g = GuardedTrainer(trainer,
                       checkpoint_manager=CheckpointManager(ckpt_dir))
    g.install_preemption_handler()
    for data, label in loader:
        loss = g.step(data, label)      # never applies a NaN update

Per step (guard enabled):

1. run ``trainer.step_guarded`` under the current loss scale, inside
   the watchdog's "step" phase;
2. GOOD step → reset the bad streak, feed the loss-scale automaton
   (may grow), let the rollback ring snapshot on its interval;
3. BAD step (non-finite loss/grad-norm; the update was already skipped
   on the device) → back off the loss scale, count against the skip
   budget, and after ``rollback_after`` consecutive bad steps rewind:
   newest ring entry first, older entries on repeat, then
   ``CheckpointManager.restore``, then ``TrainingDivergedError``.

``MXTPU_GUARD=0`` disables the whole guarded path: ``step()`` is then
one attribute check plus the plain ``trainer.step`` — the same
zero-overhead contract the telemetry registry makes.
"""

import os

from .guard import NumericGuard, TrainingDivergedError
from .rollback import RollbackRing

__all__ = ["GuardedTrainer"]


def _env_int(name, default):
    v = os.environ.get(name)
    if not v:
        return int(default)
    try:
        return int(v)
    except ValueError:
        raise ValueError("%s=%r is not an integer" % (name, v))


class GuardedTrainer:
    """Wrap a ShardedTrainer with the numeric guard, rollback ring and
    watchdog.

    Parameters
    ----------
    trainer : ShardedTrainer (or any object with step/step_guarded/
        device_snapshot/restore_device_snapshot/state_dict/
        load_state_dict — the guardian duck-types it).
    checkpoint_manager : utils.CheckpointManager, the rollback source of
        last resort and the preemption-save target (optional).
    guard / ring : NumericGuard / RollbackRing overrides (defaults are
        env-configured instances).
    watchdog : resilience.Watchdog; default picks up the process-wide
        ``watchdog.current()`` (None = no step deadlines).
    skip_budget : total bad steps tolerated per run before
        TrainingDivergedError (``MXTPU_GUARD_SKIP_BUDGET``, default 100).
    rollback_after : consecutive bad steps that trigger a rewind
        (``MXTPU_GUARD_ROLLBACK_AFTER``, default 3).
    enabled : force the guard on/off; default reads ``MXTPU_GUARD``
        (unset/1 = on, 0/false/off = off).
    """

    def __init__(self, trainer, checkpoint_manager=None, guard=None,
                 ring=None, watchdog=None, skip_budget=None,
                 rollback_after=None, enabled=None):
        if enabled is None:
            enabled = os.environ.get("MXTPU_GUARD", "1") \
                not in ("0", "false", "off")
        self._enabled = bool(enabled)
        self._trainer = trainer
        self._mgr = checkpoint_manager
        self._watchdog = watchdog
        self.skipped_steps = 0
        self.rollbacks = 0
        self._bad_streak = 0
        if not self._enabled:
            self._guard = None
            self._ring = None
            return
        self._guard = guard if guard is not None else NumericGuard()
        self._ring = ring if ring is not None else RollbackRing()
        if self._watchdog is None:
            from . import watchdog as _wd
            self._watchdog = _wd.current()
        self._skip_budget = skip_budget if skip_budget is not None \
            else _env_int("MXTPU_GUARD_SKIP_BUDGET", 100)
        self._rollback_after = rollback_after if rollback_after is not None \
            else _env_int("MXTPU_GUARD_ROLLBACK_AFTER", 3)
        if self._rollback_after < 1:
            raise ValueError("rollback_after must be >= 1")
        # prime the ring: a rollback must exist even for a run whose very
        # first steps go bad
        self._ring.snapshot(trainer)

    @property
    def loss_scale(self):
        return self._guard.scale if self._guard is not None else 1.0

    @property
    def trainer(self):
        return self._trainer

    # -------------------------------------------------------------- step
    def step(self, data, label, key=None):
        """One guarded train step; returns the (device) scalar loss of
        the step as run — on a skipped step that loss is the non-finite
        one, but the MODEL state was not touched by it."""
        if not self._enabled:
            return self._trainer.step(data, label, key=key)
        wd = self._watchdog
        if wd is not None:
            with wd.phase("step"):
                loss, bad, gnorm = self._trainer.step_guarded(
                    data, label, loss_scale=self._guard.scale, key=key)
        else:
            loss, bad, gnorm = self._trainer.step_guarded(
                data, label, loss_scale=self._guard.scale, key=key)
        if not bad:
            self._bad_streak = 0
            self._guard.on_good_step()
            self._ring.maybe_snapshot(self._trainer)
            return loss
        return self._on_bad_step(loss, gnorm)

    def _on_bad_step(self, loss, gnorm):
        from ..telemetry import catalog as _cat
        from ..telemetry import flight as _fl
        self.skipped_steps += 1
        self._bad_streak += 1
        self._guard.on_bad_step()
        _cat.guard_skipped_steps.inc()
        _fl.record("guard.skip", skipped=self.skipped_steps,
                   streak=self._bad_streak, grad_norm=repr(gnorm))
        if self.skipped_steps > self._skip_budget:
            raise TrainingDivergedError(
                "numeric guard skip budget exhausted: %d non-finite steps "
                "(budget %d, grad_norm %r, loss scale now %g)"
                % (self.skipped_steps, self._skip_budget, gnorm,
                   self._guard.scale))
        if self._bad_streak >= self._rollback_after:
            self._rollback()
            self._bad_streak = 0
        return loss

    def _rollback(self):
        from ..telemetry import catalog as _cat
        from ..telemetry import flight as _fl
        step = self._ring.rewind(self._trainer)
        if step is not None:
            self.rollbacks += 1
            _cat.guard_rollbacks.inc(source="ring")
            _fl.record("guard.rollback", source="ring", step=step)
            return step
        if self._mgr is not None:
            try:
                ck_step, params, _, _ = self._mgr.restore()
            except FileNotFoundError:
                raise TrainingDivergedError(
                    "rollback ring exhausted and no checkpoint exists "
                    "under %r" % self._mgr._dir)
            self._trainer.load_state_dict(params)
            self.rollbacks += 1
            _cat.guard_rollbacks.inc(source="checkpoint")
            _fl.record("guard.rollback", source="checkpoint",
                       step=ck_step)
            return ck_step
        raise TrainingDivergedError(
            "rollback ring exhausted and no checkpoint_manager configured")

    # ------------------------------------------------------- checkpoints
    def save_checkpoint(self, extra=None):
        """Persist the trainer's full state through the manager (the
        durable layer below the in-memory ring)."""
        if self._mgr is None:
            raise RuntimeError("GuardedTrainer has no checkpoint_manager")
        merged = {"guardian": self.stats()}
        if extra:
            merged.update(extra)
        self._mgr.save(self._trainer._step_count,
                       self._trainer.state_dict(), extra=merged)

    def install_preemption_handler(self):
        """SIGTERM → one final synchronous checkpoint of the trainer
        state (delegates to CheckpointManager.install_preemption_handler;
        also the landing path for MXTPU_WATCHDOG_SIGTERM=1). Returns the
        uninstall callable."""
        if self._mgr is None:
            raise RuntimeError("GuardedTrainer has no checkpoint_manager")
        trainer = self._trainer

        def get_state():
            return (trainer._step_count, trainer.state_dict(), None,
                    {"guardian": self.stats()})
        return self._mgr.install_preemption_handler(get_state)

    def stats(self):
        """JSON-able guardian status (also stored in checkpoint meta)."""
        out = {"enabled": self._enabled,
               "skipped_steps": self.skipped_steps,
               "rollbacks": self.rollbacks,
               "bad_streak": self._bad_streak}
        if self._enabled:
            out["loss_scale"] = self._guard.scale
            out["ring_steps"] = self._ring.steps()
            out["skip_budget"] = self._skip_budget
            out["rollback_after"] = self._rollback_after
        if self._watchdog is not None:
            out["watchdog_fired"] = list(self._watchdog.fired)
        return out
