"""Optimizers of the eager gluon path.

Counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py``: the
registry (``register``, ``create``), the ``Optimizer`` base (per-parameter
lr / wd multipliers, ``rescale_grad``, ``clip_gradient``, update counts,
``lr_scheduler``, multi-precision master copies), ``SGD``, ``NAG``,
``Adam``, ``AdamW``, the ``Updater`` with ``get_states`` / ``set_states``
in the JAX package's format (a pickle of {index: numpy state}) and
``get_updater``.

``update_multi`` of SGD (momentum > 0), Adam and AdamW puts every dense
fp32 parameter of one group, (lr, wd) for SGD and (lr, wd, t) for Adam /
AdamW, through ONE call of the ``ops/_optim_kernels.py`` seam: one launch
of the fused kernel on CUDA. Everything else (momentum 0, multi-precision
weights, ``MXTPU_FUSED_OPTIM=0``) takes the per-parameter rule. Weights and
states are updated in place: the module's forward reads those tensors.

The other optimizers of the JAX package (LBSGD, Signum, SGLD, AdaGrad,
RMSProp, AdaDelta, Adamax, Nadam, Ftrl, FTML, DCASGD) are registered by name
and raise NotImplementedError (ROADMAP Queue 1 item 14); lazy row-sparse
updates wait for the sparse NDArray (item 4).
"""

import pickle

import numpy as np
import torch

from ..ndarray import NDArray
from ..ops._optim_kernels import (_adam_update, _adamw_update,
                                  _multi_adam_update, _multi_adamw_update,
                                  _multi_sgd_mom_update, _nag_update,
                                  _sgd_mom_update, _sgd_update)
from ..ops.kernels.fused_optim import fused_optim_enabled

__all__ = ["Optimizer", "register", "create", "Updater", "get_updater",
           "SGD", "NAG", "Adam", "AdamW"]

_OPT_REGISTRY = {}
_LOW_PRECISION = (torch.float16, torch.bfloat16)


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _c(x):
    """Clip as an f32 value (<= 0 means no clipping)."""
    return np.float32(x if x is not None else -1.0)


class Optimizer:
    """Base optimizer (reference: optimizer.py:46 Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}

    # -- state ---------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        # fp32 master copy for low-precision weights
        if self.multi_precision and weight._t.dtype in _LOW_PRECISION:
            master = NDArray(weight._t.detach().float().clone())
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """Apply one batch of updates. Base: the per-parameter loop. Fused
        optimizers (SGD-momentum, Adam, AdamW) override this to put each
        group of dense fp32 parameters through one launch. Returns the
        number of fused launches (0 here)."""
        for i, w, g, st in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, st)
        return 0

    def _fusable(self, weight, grad, state):
        """Parameter eligible for the fused multi-tensor path: fp32 weight,
        plain (not multi-precision) state, the fused path enabled."""
        return (fused_optim_enabled()
                and state is not None
                and not (self.multi_precision
                         and weight._t.dtype in _LOW_PRECISION)
                and weight._t.dtype == torch.float32)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight._t.dtype in _LOW_PRECISION:
            master, inner = state
            g32 = NDArray(grad._t.float())
            self.update(index, master, g32, inner)
            with torch.no_grad():
                weight._t.copy_(master._t)
        else:
            self.update(index, weight, grad, state)

    # -- hyperparams ---------------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


# ---------------------------------------------------------------------------
# optimizer classes
# ---------------------------------------------------------------------------

def _zeros_like(weight):
    return NDArray(torch.zeros(weight.shape, dtype=weight._t.dtype,
                               device=weight._t.device))


@register
class SGD(Optimizer):
    """SGD with momentum and optional multi-precision (reference: sgd_update
    / sgd_mom_update / mp_sgd_update in optimizer_op.cc)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _sgd_update(weight._t, grad._t, lr, wd, self.rescale_grad,
                        _c(self.clip_gradient))
        else:
            _sgd_mom_update(weight._t, grad._t, state._t, lr, wd,
                            self.momentum, self.rescale_grad,
                            _c(self.clip_gradient))

    def update_multi(self, indices, weights, grads, states):
        """Fused SGD-momentum: dense fp32 parameters grouped by (lr, wd)
        update in ONE launch per group; the rest (multi-precision,
        momentum 0) per parameter."""
        groups, rest = {}, []
        for i, w, g, st in zip(indices, weights, grads, states):
            if self.momentum == 0.0 or not self._fusable(w, g, st):
                rest.append((i, w, g, st))
                continue
            self._update_count(i)
            groups.setdefault((self._get_lr(i), self._get_wd(i)),
                              []).append((w, g, st))
        for (lr, wd), items in groups.items():
            _multi_sgd_mom_update(
                [w._t for w, _, _ in items], [g._t for _, g, _ in items],
                [s._t for _, _, s in items], lr, wd, self.momentum,
                self.rescale_grad, _c(self.clip_gradient))
        for i, w, g, st in rest:
            self.update_multi_precision(i, w, g, st)
        return len(groups)


@register
class NAG(Optimizer):
    """Nesterov momentum (reference: nag_mom_update); no fused path."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _nag_update(weight._t, grad._t, state._t, self._get_lr(index),
                    self._get_wd(index), self.momentum, self.rescale_grad,
                    _c(self.clip_gradient))


class _AdamBase(Optimizer):
    """Adam's state and its fused grouping by (lr, wd, t)."""

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _multi(self, ws, gs, ms, vs, lr, wd, t):
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """Fused multi-tensor update: dense fp32 parameters grouped by
        (lr, wd, t), one launch per group."""
        groups, rest = {}, []
        for i, w, g, st in zip(indices, weights, grads, states):
            if not self._fusable(w, g, st):
                rest.append((i, w, g, st))
                continue
            self._update_count(i)
            t = self._index_update_count[i]
            groups.setdefault((self._get_lr(i), self._get_wd(i), t),
                              []).append((w, g, st))
        for (lr, wd, t), items in groups.items():
            self._multi([w._t for w, _, _ in items],
                        [g._t for _, g, _ in items],
                        [st[0]._t for _, _, st in items],
                        [st[1]._t for _, _, st in items], lr, wd, t)
        for i, w, g, st in rest:
            self.update_multi_precision(i, w, g, st)
        return len(groups)


@register
class Adam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        m, v = state
        _adam_update(weight._t, grad._t, m._t, v._t, self._get_lr(index),
                     self._get_wd(index), self.beta1, self.beta2,
                     self.epsilon, t, self.rescale_grad,
                     _c(self.clip_gradient))

    def _multi(self, ws, gs, ms, vs, lr, wd, t):
        _multi_adam_update(ws, gs, ms, vs, lr, wd, self.beta1, self.beta2,
                           self.epsilon, t, self.rescale_grad,
                           _c(self.clip_gradient))


@register
class AdamW(_AdamBase):
    """Decoupled weight decay (reference: contrib adamw_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon, self.eta = (beta1, beta2,
                                                          epsilon, eta)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        m, v = state
        _adamw_update(weight._t, grad._t, m._t, v._t, self._get_lr(index),
                      self._get_wd(index), self.eta, self.beta1, self.beta2,
                      self.epsilon, t, self.rescale_grad,
                      _c(self.clip_gradient))

    def _multi(self, ws, gs, ms, vs, lr, wd, t):
        _multi_adamw_update(ws, gs, ms, vs, lr, wd, self.eta, self.beta1,
                            self.beta2, self.epsilon, t, self.rescale_grad,
                            _c(self.clip_gradient))


def _later(name):
    class _Later(Optimizer):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                "optimizer %r is not ported yet (ROADMAP Queue 1 item 14)"
                % name.lower())
    _Later.__name__ = _Later.__qualname__ = name
    return register(_Later)


for _name in ("LBSGD", "Signum", "SGLD", "AdaGrad", "RMSProp", "AdaDelta",
              "Adamax", "Nadam", "Ftrl", "FTML", "DCASGD"):
    globals()[_name] = _later(_name)
del _name


# ---------------------------------------------------------------------------
# Updater (kvstore-side optimizer application; reference: optimizer.py:1621)
# ---------------------------------------------------------------------------

class Updater:
    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.fused_launches = 0     # groups updated by a fused launch

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        else:   # states loaded by set_states live on the host until used
            self.states[index] = _state_to(self.states[index],
                                           weight._t.device)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        """Batched form of __call__: the whole step's parameters at once, so
        fused optimizers put each group through one launch."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        launches = self.optimizer.update_multi(indices, weights, grads,
                                               states)
        self.fused_launches += launches
        return launches

    def get_states(self, dump_optimizer=False):
        return pickle.dumps({k: _state_numpy(v)
                             for k, v in self.states.items()})

    def set_states(self, states):
        raw = pickle.loads(states)
        self.states = {k: _state_from_numpy(v) for k, v in raw.items()}


def _state_numpy(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_state_numpy(s) for s in state)
    return state.asnumpy()


def _state_from_numpy(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_from_numpy(s) for s in state)
    return NDArray(torch.from_numpy(np.array(state)))


def _state_to(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_to(s, device) for s in state)
    if state._t.device != device:
        state._t = state._t.to(device)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
