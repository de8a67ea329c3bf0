"""Numeric guard: dynamic loss scaling + skip-step policy state.

Counterpart of ``incubator_mxnet_tpu/resilience/guard.py``. The device
side of the guard lives in ``ShardedTrainer.step_guarded`` (finite check
and skip by select on the device); this module is the HOST side — the
loss-scale automaton the guardian consults between steps:

- after every good step the scale may GROW (×growth_factor once
  ``growth_interval`` consecutive good steps accumulate);
- after every bad step (non-finite loss/grad-norm) the scale BACKS OFF
  (×backoff_factor, streak resets) — an overflowed backward at the
  next-smaller scale usually turns finite again within a few steps.

Defaults follow the standard mixed-precision recipe (grow ×2 every 200
good steps, back off ×0.5, scale clamped to [min, max]). For pure-fp32
training a scale of 1.0 with growth disabled degrades gracefully: the
guard is then only the finite-check + skip policy.
"""

import os

__all__ = ["NumericGuard", "TrainingDivergedError"]


class TrainingDivergedError(RuntimeError):
    """Raised by GuardedTrainer when the skip budget is exhausted or no
    rollback source remains — the run cannot make healthy progress."""


def _env_float(name, default):
    v = os.environ.get(name)
    if not v:
        return float(default)
    try:
        return float(v)
    except ValueError:
        raise ValueError("%s=%r is not a number" % (name, v))


class NumericGuard:
    """Host-side dynamic loss-scale automaton.

    Parameters (each falls back to its env var, then the default):

    init_scale : starting loss scale
        (``MXTPU_GUARD_INIT_SCALE``, default 2**16)
    growth_factor : multiplier on growth (``MXTPU_GUARD_GROWTH_FACTOR``,
        default 2.0)
    backoff_factor : multiplier on a bad step
        (``MXTPU_GUARD_BACKOFF_FACTOR``, default 0.5)
    growth_interval : consecutive good steps before one growth
        (``MXTPU_GUARD_GROWTH_INTERVAL``, default 200)
    min_scale / max_scale : clamp bounds (``MXTPU_GUARD_MIN_SCALE``
        default 1.0, ``MXTPU_GUARD_MAX_SCALE`` default 2**24)
    """

    def __init__(self, init_scale=None, growth_factor=None,
                 backoff_factor=None, growth_interval=None,
                 min_scale=None, max_scale=None):
        def pick(v, env, dflt):
            return float(v) if v is not None else _env_float(env, dflt)
        self.scale = pick(init_scale, "MXTPU_GUARD_INIT_SCALE", 2.0 ** 16)
        self.growth_factor = pick(growth_factor,
                                  "MXTPU_GUARD_GROWTH_FACTOR", 2.0)
        self.backoff_factor = pick(backoff_factor,
                                   "MXTPU_GUARD_BACKOFF_FACTOR", 0.5)
        self.growth_interval = int(pick(growth_interval,
                                        "MXTPU_GUARD_GROWTH_INTERVAL", 200))
        self.min_scale = pick(min_scale, "MXTPU_GUARD_MIN_SCALE", 1.0)
        self.max_scale = pick(max_scale, "MXTPU_GUARD_MAX_SCALE", 2.0 ** 24)
        if not self.min_scale <= self.scale <= self.max_scale:
            raise ValueError("init_scale %g outside [min_scale %g, "
                             "max_scale %g]" % (self.scale, self.min_scale,
                                                self.max_scale))
        self.good_streak = 0
        self._gauge()

    def _gauge(self):
        from ..telemetry import catalog as _cat
        from ..telemetry import flight as _fl
        _cat.guard_loss_scale.set(self.scale)
        _fl.record("guard.loss_scale", scale=self.scale)

    def on_good_step(self):
        """Record a finite step; grow the scale on a full streak."""
        self.good_streak += 1
        if self.growth_interval > 0 and \
                self.good_streak >= self.growth_interval:
            self.good_streak = 0
            new = min(self.scale * self.growth_factor, self.max_scale)
            if new != self.scale:
                self.scale = new
                self._gauge()

    def on_bad_step(self):
        """Record a non-finite step; back the scale off, reset streak."""
        self.good_streak = 0
        new = max(self.scale * self.backoff_factor, self.min_scale)
        if new != self.scale:
            self.scale = new
            self._gauge()
