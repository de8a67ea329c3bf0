"""Learning-rate schedules as CLOSED-FORM functions of the update count.

Counterpart of ``incubator_mxnet_tpu/lr_scheduler.py``, which is plain
Python and is carried over unchanged (Factor/MultiFactor/Poly/Cosine +
warmup; reference surface python/mxnet/lr_scheduler.py). The reference
mutates ``self.base_lr`` step by step inside ``__call__``; here every
schedule is a pure function
``lr(t)`` — the same observable lr sequence for the optimizer's
monotonically increasing ``num_update``, but reentrant and resume-safe
(restoring a trainer at step N needs no replay of N calls). ``base_lr``
still tracks the most recent post-warmup value for introspection parity.
"""

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: warmup handling + the ``lr(t)`` template. Subclasses override
    ``_schedule(t)`` mapping the post-warmup step count to an lr."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant'")
        self.base_lr = base_lr
        self.base_lr_orig = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / self.warmup_steps
        return self.warmup_begin_lr \
            + (self.warmup_final_lr - self.warmup_begin_lr) * frac

    def _schedule(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        self.base_lr = self._schedule(num_update)
        return self.base_lr


class FactorScheduler(LRScheduler):
    """lr(t) = max(stop_factor_lr, base_lr * factor^floor((t-1)/step))."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, **kwargs):
        super().__init__(**kwargs)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _schedule(self, num_update):
        n_decays = max(0, (num_update - 1)) // self.step
        lr = self.base_lr_orig * self.factor ** n_decays
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr(t) = base_lr * factor^|{milestone s : t > s}|."""

    def __init__(self, step, factor=1, **kwargs):
        super().__init__(**kwargs)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        self.step = step
        self.factor = factor

    def _schedule(self, num_update):
        passed = sum(1 for s in self.step if num_update > s)
        return self.base_lr_orig * self.factor ** passed


class _AnnealToFinal(LRScheduler):
    """Shared shape for Poly/Cosine: anneal base_lr -> final_lr over
    ``max_update - warmup_steps`` steps via ``_frac`` in [0, 1]."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def _frac(self, progress):
        raise NotImplementedError

    def _schedule(self, num_update):
        # clamp, don't early-return: a freshly-restored scheduler queried
        # past max_update must yield final_lr, not the initial base_lr
        progress = min(1.0, (num_update - self.warmup_steps)
                       / self.max_steps)
        return self.final_lr \
            + (self.base_lr_orig - self.final_lr) * self._frac(progress)


class PolyScheduler(_AnnealToFinal):
    """Polynomial decay: frac = (1 - progress)^pwr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kwargs):
        super().__init__(max_update, base_lr, final_lr, **kwargs)
        self.power = pwr

    def _frac(self, progress):
        return (1.0 - progress) ** self.power


class CosineScheduler(_AnnealToFinal):
    """Cosine decay: frac = (1 + cos(pi * progress)) / 2."""

    def _frac(self, progress):
        return 0.5 * (1.0 + math.cos(math.pi * progress))
